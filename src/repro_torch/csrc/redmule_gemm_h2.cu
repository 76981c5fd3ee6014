// The h2 form of the GEMM-Op kernel's SIMT schedule: its launches, apart
// from redmule_gemm.cu so that the two compile in parallel (the note is
// there).
#include "redmule_simt.cuh"

namespace redmule_simt {

namespace {

template <int CIRC, int STAR>
cudaError_t launch_h2_pair(int compute_dt, const GemmArgs& a, dim3 grid, cudaStream_t st) {
  if (compute_dt == DT_F16) return launch_tile<FORM_H2, CIRC, STAR, DT_F16>(a, grid, st);
  if (compute_dt == DT_BF16) return launch_tile<FORM_H2, CIRC, STAR, DT_BF16>(a, grid, st);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_h2(int circ, int star, int compute_dt, const GemmArgs& a, dim3 grid,
                      cudaStream_t st) {
  switch (circ * 4 + star) {
    case OP_ADD * 4 + OP_MAX: return launch_h2_pair<OP_ADD, OP_MAX>(compute_dt, a, grid, st);
    case OP_ADD * 4 + OP_MIN: return launch_h2_pair<OP_ADD, OP_MIN>(compute_dt, a, grid, st);
    case OP_MUL * 4 + OP_MAX: return launch_h2_pair<OP_MUL, OP_MAX>(compute_dt, a, grid, st);
    case OP_MUL * 4 + OP_MIN: return launch_h2_pair<OP_MUL, OP_MIN>(compute_dt, a, grid, st);
    case OP_MAX * 4 + OP_MIN: return launch_h2_pair<OP_MAX, OP_MIN>(compute_dt, a, grid, st);
    case OP_MIN * 4 + OP_MAX: return launch_h2_pair<OP_MIN, OP_MAX>(compute_dt, a, grid, st);
    default: return cudaErrorInvalidValue;  // (mul, add) takes the f32 form or the tensor cores
  }
}

}  // namespace redmule_simt
