// bf16 conversions: see cuda_runtime.h in this directory.
#pragma once
#include "cuda_runtime.h"
