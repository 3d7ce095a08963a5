// Device marks of the training step's phases (fmov_pose_torch/tracing.py
// mark): one empty kernel a phase, each named for it, launched <<<1, 1>>>
// on the caller's stream.  A captured CUDA graph keeps each launch as a
// kernel node, so every replay runs it and the profiler's device trace
// shows where each phase of each step starts; the benchmark's phase
// readers (benchmark/phases.py) split a step's device time at them.
//
// It replaces no TPU kernel: it was added to name the port's step phases
// on the device timeline, which a graph replay leaves without profiler
// ranges.  Each costs one launch and no work.  It includes no .cuh, so it
// has no part in the other kernels' shared sources.

#include <cuda_runtime.h>

extern "C" {

__global__ void fmov_mark_pose() {}
__global__ void fmov_mark_render() {}
__global__ void fmov_mark_loss() {}
__global__ void fmov_mark_backward() {}
__global__ void fmov_mark_update() {}
__global__ void fmov_mark_end() {}

// phase: the index in tracing.PHASES; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unknown phase).
int fmov_mark(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: fmov_mark_pose<<<1, 1, 0, s>>>(); break;
    case 1: fmov_mark_render<<<1, 1, 0, s>>>(); break;
    case 2: fmov_mark_loss<<<1, 1, 0, s>>>(); break;
    case 3: fmov_mark_backward<<<1, 1, 0, s>>>(); break;
    case 4: fmov_mark_update<<<1, 1, 0, s>>>(); break;
    case 5: fmov_mark_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fmov_mark_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
