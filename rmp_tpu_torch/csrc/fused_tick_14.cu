// K5's 16-lane kernel (fused_tick.cuh) for n = 14..16; see fused_tick.cu.
#include "fused_tick.cuh"

namespace rmp_k5 {

void launch_narrow_14(int n, const NarrowLaunch& a) {
  launch_range<14, 16>(n, a);
}

}  // namespace rmp_k5
