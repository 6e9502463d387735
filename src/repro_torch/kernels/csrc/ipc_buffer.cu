// ipc_buffer.cu -- device buffers that the processes of one card share
// through CUDA IPC (no kernel).
//
// launch/mesh.py gives each rank of a mesh whose ranks share one card an
// exchange buffer of its own, allocated here with cudaMalloc (outside the
// caching allocator, so its IPC handle does not depend on the allocator's
// segment layout), exports its cudaIpcMemHandle_t (64 bytes) and opens
// every other rank's: a collective then copies device to device through
// the opened pointers instead of staging through host memory and a TCP
// socket.
//
// C interface for ctypes: each entry returns the cudaError_t of its call.
// The buffers live as long as the process (its exit frees and unmaps
// them).

#include <cuda_runtime.h>
#include <string.h>

extern "C" int ipc_alloc(long long bytes, void** ptr) {
  return (int)cudaMalloc(ptr, (size_t)bytes);
}

// the 64-byte handle of an allocation made by ipc_alloc
extern "C" int ipc_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(out, &h, sizeof(h));
  return (int)err;
}

// another process's allocation, mapped into this one
extern "C" int ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }
