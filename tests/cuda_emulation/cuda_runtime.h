// Stands in for the CUDA runtime header in the CPU emulation.
#pragma once
