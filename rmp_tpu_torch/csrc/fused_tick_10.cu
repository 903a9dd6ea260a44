// K5's 16-lane kernel (fused_tick.cuh) for n = 10..13; see fused_tick.cu.
#include "fused_tick.cuh"

namespace rmp_k5 {

void launch_narrow_10(int n, const NarrowLaunch& a) {
  launch_range<10, 13>(n, a);
}

}  // namespace rmp_k5
