// gru_seq: G independent GRU recurrences over T steps in ONE launch: a
// thread-block cluster per (recurrence, group of up to 4 batch rows) that
// keeps U in its CTAs' shared memory and exchanges h through distributed
// shared memory each step.
//
// Replaces the TPU kernel gru_seq_pallas / _seq_kernel
// (src/repro/kernels/gru_cell/kernel.py:111 / :31).  Same function: per
// step hu = h . U (gate order z, r, n), z = sigmoid(xw_z + hu_z),
// r = sigmoid(xw_r + hu_r), n = tanh(xw_n + r * hu_n),
// h = (1 - z) * n + z * h; masked rows (b_mask == 0) freeze h, and hs
// repeats it; hs and h_T come out in h0's dtype.  There is no cell state.
//
// What bounds it on an H100: latency, as in lstm_seq.cu.  A step is one
// product h . U (H x 3H: 1.39 MB in fp32, 0.69 MB in bf16 at H = 340),
// one reduction, the cell and an exchange, and the steps are a chain; the
// bytes bound is under a microsecond.  The previous design read all of U
// through one SM every step.
//
// The design is lstm_seq.cu's (seq_cluster.cuh) with three gates: the S
// CTAs of a cluster (16 at H = 340, 1024 and 2048;
// kernels.common.seq_splits(H, 3, ...)) each own a slice of hidden units
// with its z, r and n columns, so the reset gate's coupling
// n = tanh(xw_n + r * hu_n) stays inside the CTA: the raw hu_n is kept
// apart from xw_n until r is known.  U stays in shared memory (all of it
// at H = 340; the first rows of each thread at H = 1024 and 2048, the
// rest streamed from L2 every step); h goes to every CTA through
// distributed shared memory as st.async stores completing on the
// receiver's mbarrier.  H % 4 != 0 (3H not a multiple of four) takes
// plain loads (V = 1).
//
// The reference's two weight branches (kernel.py:69-89), chosen at run
// time as in lstm_seq.cu: int8 U (`scales` given) is upcast without its
// scale and accumulated in fp32, and the per-gate scale multiplies the
// finished sum of all three gates BEFORE the cell couples r * hu_n
// (kernel.py:88-93), so the gates see (h . Uq) * s; row-compacted U
// (`rows` given) runs the product over its Ha rows with h gathered
// through the row index, padding rows adding exactly 0.0.
//
// Numerics as the reference's: U is upcast to fp32 before the product and
// accumulated in fp32; h is seeded from h0 in fp32, carried in fp32
// between steps and rounded to h0's dtype only where it is stored (hs,
// h_T; kernel.py:66, :103-108), so block_t (a planning parameter) cannot
// change the result.

#include "seq_cluster.cuh"

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// U (G, Hr, 3, H) with Hr = H, or Hr = Ha rows when `rows` is given;
// scales (G, 3) fp32 or NULL; rows (G, Ha) int32 or NULL; xw (G, B, T, 3,
// H); h0 (G, B, H); mask (G, B) int32 or NULL; outputs hs (G, B, T, H) and
// hT (G, B, H) in h0's dtype.  u_type picks U's type (0 fp32, 1 bf16, 2
// int8, which comes with scales); *_bf16 flags pick bfloat16 over fp32 for
// xw and h.  Launches on `stream` and returns the CUDA error (0 = ok;
// anything else is a refused launch, as lstm_seq_launch's).
extern "C" int gru_seq_launch(const void* U, const void* scales,
                              const void* rows, const void* xw,
                              const void* h0, const void* mask, void* hs,
                              void* hT, int G, int B, int T, int H, int Hr,
                              int u_type, int xw_bf16, int h_bf16,
                              void* stream) {
  const seq::Args a{U, static_cast<const float*>(scales),
                    static_cast<const int*>(rows), xw, h0, nullptr,
                    static_cast<const int*>(mask), hs, hT, nullptr, G, B, T,
                    H, Hr, u_type, xw_bf16, h_bf16,
                    static_cast<cudaStream_t>(stream)};
  return seq::launch<rnn::GruCell>(a);
}

// What a launch at (B, H, Hr, u_type) takes, without launching: as
// lstm_seq_shape.
extern "C" int gru_seq_shape(int B, int H, int Hr, int u_type, int* out) {
  return seq::query<rnn::GruCell>(B, H, Hr, u_type, out);
}
