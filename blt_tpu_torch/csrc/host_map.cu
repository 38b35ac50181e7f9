// The direct upload of a mapped input (pipeline/feeder.py MappedWindows):
// a window of the file mapping is page-locked for the card, read-only, and
// each batch in it goes to the device by one asynchronous copy from the
// mapping itself, with no copy into pinned staging.
//
// A refused registration is the caller's to handle (the window takes the
// staging copy), so its error is cleared here: it must not surface at the
// next launch's cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

extern "C" int blt_host_register(void* ptr, int64_t n) {
  cudaError_t err = cudaHostRegister(ptr, (size_t)n, cudaHostRegisterReadOnly);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int blt_host_unregister(void* ptr) {
  cudaError_t err = cudaHostUnregister(ptr);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" int blt_h2d(void* dst, const void* src, int64_t n, void* stream) {
  if (n <= 0) return 0;
  return (int)cudaMemcpyAsync(dst, src, (size_t)n, cudaMemcpyHostToDevice,
                              (cudaStream_t)stream);
}
