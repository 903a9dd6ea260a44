// K1's CTA kernel (pullback_resolve_cta.cuh, whose head note holds its
// design) for n = 33..64, a warp an env: n at run time inside two
// instantiations, kMaxN = 40 (n = 33..40, here) and 64 (n = 41..64,
// pullback_resolve_cta_64.cu; nvcc builds the two files at once); the
// dispatch, and the C entry point that reports a layout's shared bytes and
// envs an SM.
#include "pullback_resolve_cta.cuh"

namespace rmp_k1 {

void launch_cta(int n, int B, const Table& table, float ridge, float* out,
                cudaStream_t stream) {
  if (n <= 40)
    cta::launch<40>(n, B, table, ridge, out, stream);
  else
    launch_cta_64(n, B, table, ridge, out, stream);
}

}  // namespace rmp_k1

// out[0]: the dynamic shared bytes a CTA (an env) of the kernel that takes
// n asks for at B envs; out[1]: the CTAs an SM holds at that size; out[2]:
// the instantiation's kMaxN. Returns -1 for an n outside 33..64.
extern "C" int rmp_pullback_resolve_cta_residency(int n, int B, int* out) {
  if (n <= rmp_k1::kMaxWarpN || n > rmp_k1::kMaxN) return -1;
  if (n <= 40) {
    rmp_k1::cta::residency<40>(B, out[0], out[1]);
    out[2] = 40;
  } else {
    rmp_k1::residency_cta_64(B, out);
  }
  return 0;
}
