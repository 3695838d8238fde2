"""Fixtures the port's protocol suites share (``tests/test_torch_*.py``
import them by name): the bridge parametrisation and the lifecycle
monitor, as ``tests/conftest.py`` arms them for the JAX package's suites,
here over the port's modules.

``bridge_mode`` is ``inmemory`` or ``socket``. ``socket`` reroutes every
``repro_torch`` ``AlchemistContext(engine=...)`` construction through a
real TCP server (``repro_torch.core.server``) wrapped around *the same
engine object*: the context talks frames over localhost while the test
keeps direct in-process access to the engine for its assertions. One
server per distinct engine, started lazily, stopped at test teardown.
A module that imports the fixture runs every test over both bridges
(the name shadows the conftest's autouse ``bridge_mode``)."""
import pytest


@pytest.fixture(params=["inmemory", "socket"])
def bridge_mode(request, monkeypatch):
    mode = request.param
    if mode != "socket":
        yield mode
        return

    from repro_torch.core import wire
    from repro_torch.core.context import AlchemistContext
    from repro_torch.core.engine import AlchemistEngine
    from repro_torch.core.server import AlchemistServer

    servers = {}                       # id(engine) -> AlchemistServer
    real_init = AlchemistContext.__init__

    def socket_init(self, num_workers=None, engine=None, **kw):
        if kw.get("address") is not None \
                or isinstance(engine, wire.SocketBridge):
            return real_init(self, num_workers=num_workers,
                             engine=engine, **kw)
        device = kw.pop("device", "cuda")
        if engine is None:
            engine = AlchemistEngine(device=device, num_workers=num_workers)
        srv = servers.get(id(engine))
        if srv is None:
            srv = AlchemistServer(engine=engine).start()
            servers[id(engine)] = srv
        return real_init(self, address=srv.address, **kw)

    monkeypatch.setattr(AlchemistContext, "__init__", socket_init)
    yield mode
    for srv in servers.values():
        srv.stop()


@pytest.fixture()
def stm_monitor(monkeypatch):
    """The port's lifecycle monitor, armed for the test: every engine,
    scheduler and server built inside it records its transitions, and the
    test fails on any illegal edge, orphan, remint or dead-scope
    activity. A module that imports it arms it for every test (the name
    shadows the conftest's autouse ``stm_monitor``, keyed on the JAX
    package's suites)."""
    from repro_torch.analysis import statemachine
    monkeypatch.setenv(statemachine.ENV_FLAG, "1")
    statemachine.TRACE.reset()
    yield
    statemachine.TRACE.assert_clean()
    statemachine.TRACE.reset()
