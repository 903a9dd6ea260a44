// K1's warp kernel (pullback_resolve_wide.cuh) for n = 28..30; see
// pullback_resolve_wide.cu.
#include "pullback_resolve_wide.cuh"

namespace rmp_k1 {

void launch_wide_28(int n, int B, const Table& table, float ridge,
                    float* out, cudaStream_t stream) {
  launch_range<28, 30>(n, B, table, ridge, out, stream);
}

}  // namespace rmp_k1
