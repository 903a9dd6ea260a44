// K1's CTA kernel (pullback_resolve_cta.cuh) at kMaxN = 64 (n = 41..64);
// see pullback_resolve_cta.cu.
#include "pullback_resolve_cta.cuh"

namespace rmp_k1 {

void launch_cta_64(int n, int B, const Table& table, float ridge, float* out,
                   cudaStream_t stream) {
  cta::launch<64>(n, B, table, ridge, out, stream);
}

void residency_cta_64(int B, int* out) {
  cta::residency<64>(B, out[0], out[1]);
  out[2] = 64;
}

}  // namespace rmp_k1
