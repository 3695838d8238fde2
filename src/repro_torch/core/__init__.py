# The paper's primary contribution: the Alchemist offload system —
# client context + lazy AlMatrix expression layer + typed library
# façades + matrix handles + engine + transfer, with async futures over
# the engine's hazard-aware task scheduler.
from repro_torch.core.context import AlchemistContext
from repro_torch.core.engine import AlchemistEngine
from repro_torch.core.expr import AlchemistBusyError, AlchemistError, \
    AlFuture, AlMatrix, LibraryProxy
from repro_torch.core.handles import MatrixHandle

__all__ = ["AlchemistBusyError", "AlchemistContext", "AlchemistError",
           "AlFuture", "AlMatrix", "AlchemistEngine", "LibraryProxy",
           "MatrixHandle"]
