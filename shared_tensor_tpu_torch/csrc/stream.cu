// A CUDA stream of its own for a SharedTensor: no kernel, a host helper
// built beside the kernels.
//
// PyTorch's torch.cuda.Stream() hands out the streams of a fixed pool (32
// per device and priority) in turn, so two callers may get the same one.
// A node captures CUDA graphs on its side stream, and a capture records
// whatever any thread enqueues on that stream, so the stream must be the
// node's alone. This one is created with cudaStreamNonBlocking (no implicit
// synchronisation with the legacy default stream, which a capture would
// refuse) and wrapped by torch.cuda.ExternalStream on the Python side.

#include <cuda_runtime.h>

extern "C" int st_stream_create(int device, void** out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = nullptr;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaSetDevice(prev);
  *out = (void*)s;
  return (int)err;
}
