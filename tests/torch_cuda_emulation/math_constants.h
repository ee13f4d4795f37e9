// CUDART_INF_F of the CUDA toolkit's math_constants.h, for the host emulation.
#pragma once
#include <limits>
#define CUDART_INF_F std::numeric_limits<float>::infinity()
