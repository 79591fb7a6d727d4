// Error strings for the codes the entry points return.
#include "common.cuh"

DV_EXPORT const char* dv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
