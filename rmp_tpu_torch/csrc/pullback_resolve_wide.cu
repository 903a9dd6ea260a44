// K1's warp kernel (pullback_resolve_wide.cuh, whose head note holds its
// design and what bounds it) for n = 10..17, and the dispatch of every
// n = 10..32: the instantiations are split over three source files
// (pullback_resolve_wide_18.cu: 18..24, pullback_resolve_wide_25.cu:
// 25..32), which nvcc builds at once, one process each.
#include "pullback_resolve_wide.cuh"

namespace rmp_k1 {

void launch_wide(int n, int B, const Table& table, float ridge, float* out,
                 cudaStream_t stream) {
  if (n <= 17)
    launch_range<kMaxLaneN + 1, 17>(n, B, table, ridge, out, stream);
  else if (n <= 24)
    launch_wide_18(n, B, table, ridge, out, stream);
  else
    launch_wide_25(n, B, table, ridge, out, stream);
}

}  // namespace rmp_k1
