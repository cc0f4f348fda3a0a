// Error reporting for the ctypes-bound launchers.
#include "afk.cuh"

AFK_API const char* afk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
