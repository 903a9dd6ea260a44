// K1's CTA kernel (pullback_resolve_cta.cuh, whose head note holds its
// design) for n = 33..64, n taken at run time inside two instantiations:
// kMaxN = 48 (n = 33..48) and 64 (n = 49..64). A CTA per env.
#include "pullback_resolve_cta.cuh"

namespace rmp_k1 {

namespace {

template <int kMaxN>
void launch_at(int n, int B, const Table& table, float ridge, float* out,
               cudaStream_t stream) {
  cta::pullback_resolve_cta_kernel<kMaxN>
      <<<B, cta::kThreads, 0, stream>>>(n, table, ridge, out);
}

}  // namespace

void launch_cta(int n, int B, const Table& table, float ridge, float* out,
                cudaStream_t stream) {
  if (n <= 48)
    launch_at<48>(n, B, table, ridge, out, stream);
  else
    launch_at<64>(n, B, table, ridge, out, stream);
}

}  // namespace rmp_k1
