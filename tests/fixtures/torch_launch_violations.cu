// Deliberately-broken CUDA launchers exercised by tests/test_torch_analysis.py
// (scanned as text, never built). bad_launch makes each CUDA runtime call
// the port's TRC001 bans in an extern "C" launcher, one per line;
// good_launch stays asynchronous on the caller's stream. Comments naming
// cudaDeviceSynchronize() must not count.
#include <cuda_runtime.h>

__global__ void copy_kernel(const float* a, float* o, long n) {
    long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
    if (i < n) o[i] = a[i];
}

extern "C" int declared_only(int dtype);

extern "C" int bad_launch(const float* a, float* o, long n, void* stream) {
    float* scratch = nullptr;
    cudaMalloc(&scratch, n * sizeof(float));
    copy_kernel<<<(n + 255) / 256, 256>>>(a, scratch, n);
    cudaMemcpy(o, scratch, n * sizeof(float), cudaMemcpyDeviceToDevice);
    cudaDeviceSynchronize();
    cudaStreamSynchronize((cudaStream_t)stream);
    cudaFree(scratch);
    return 0;
}

extern "C" int good_launch(const float* a, float* o, long n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    /* no cudaMemcpy( here: the async form is fine */
    cudaMemcpyAsync(o, a, n * sizeof(float), cudaMemcpyDeviceToDevice, s);
    copy_kernel<<<(n + 255) / 256, 256, 0, s>>>(a, o, n);
    return (int)cudaGetLastError();
}
