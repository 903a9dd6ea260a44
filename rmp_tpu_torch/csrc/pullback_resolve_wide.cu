// K1's warp kernel (pullback_resolve_wide.cuh, whose head note holds its
// design and what bounds it) for n = 10..13, and the dispatch of every
// n = 10..32: the instantiations are split over seven source files
// (pullback_resolve_wide_14.cu: 14..17, _18: 18..21, _22: 22..24, _25:
// 25..27, _28: 28..30, _31: 31..32), which nvcc builds at once, one process
// each.
#include "pullback_resolve_wide.cuh"

namespace rmp_k1 {

void launch_wide(int n, int B, const Table& table, float ridge, float* out,
                 cudaStream_t stream) {
  if (n <= 13)
    launch_range<kMaxLaneN + 1, 13>(n, B, table, ridge, out, stream);
  else if (n <= 17)
    launch_wide_14(n, B, table, ridge, out, stream);
  else if (n <= 21)
    launch_wide_18(n, B, table, ridge, out, stream);
  else if (n <= 24)
    launch_wide_22(n, B, table, ridge, out, stream);
  else if (n <= 27)
    launch_wide_25(n, B, table, ridge, out, stream);
  else if (n <= 30)
    launch_wide_28(n, B, table, ridge, out, stream);
  else
    launch_wide_31(n, B, table, ridge, out, stream);
}

}  // namespace rmp_k1
