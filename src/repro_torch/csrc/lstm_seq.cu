// lstm_seq: G independent LSTM recurrences over T steps in ONE launch: a
// thread-block cluster per (recurrence, group of up to 4 batch rows) that
// keeps U in its CTAs' shared memory and exchanges h through distributed
// shared memory each step.
//
// Replaces the TPU kernel lstm_seq_pallas / _seq_kernel
// (src/repro/kernels/lstm_cell/kernel.py:205 / :113).  Same function: per
// step gates = xw[:, t] + h . U (gate order i, f, g, o), c = f*c + i*g,
// h = o*tanh(c); masked rows (b_mask == 0) freeze h and c; hs and h_T come
// out in h0's dtype, c_T in fp32.
//
// What bounds it on an H100: latency.  One recurrence is a chain of T
// small products h . U (H x 4H: 1.85 MB in fp32, 0.92 MB in bf16 at H =
// 340), each waiting on the last; the bytes bound (U, xw and the states
// read once) is about a microsecond, while each step costs one product,
// one reduction, the cell and an exchange.  The previous design ran a
// whole recurrence in one 512-thread block and read all of U through that
// one SM every step (~50 GB/s out of L2, ~36 us a step at G=2 B=4 H=340).
//
// The design (seq_cluster.cuh): the S CTAs of a cluster (16 at H = 340,
// 1024 and 2048; kernels.common.seq_splits) each own a slice of hidden
// units with its four gate columns, so c, the gates and the mask freeze
// stay in the CTA.  Each CTA copies its slice of U into shared memory
// once a launch (all of it at H = 340; at H = 1024 and 2048 its first
// rows, the rest streamed from L2 every step through per-thread cp.async
// rings), so a step reads U at shared-memory rate on 16 SMs; the new h
// slice goes to every CTA through distributed shared memory, as st.async
// stores that complete on the receiver's mbarrier (no cluster barrier a
// step).  Each output's fp32 sum order depends on (H, gates, U's type,
// Hr) only.  On an H100 a step at G=2 B=4 H=340 takes ~3.6 us (the launch
// in a CUDA graph, T = 8, over T); a clock profile of a copy put about a
// third of it in the product, a quarter in the partials' reduction and
// its barriers, and the rest in the cell, the stores and the wait for h.
// At H = 1024 the stream out of L2 sets the step (~15-19 us).
//
// Tried and dropped (timed on the card beside this design): one cluster
// barrier a step after DSMEM pushes (the arrive's release waited for the
// remote stores); cp.async groups of 2-4 rows and a 96 KB ring for the
// streamed rows (no faster, or slower); 8 fp32 columns a thread (two
// 16-byte copies a row: slower at H = 1024 and 2048, so fp32 keeps 4).
//
// The reference's two weight branches (kernel.py:170-177), both chosen at
// run time: int8 U (`scales` given) is copied and read in its int8 form,
// upcast without its scale and accumulated in fp32, and the per-gate scale
// multiplies the finished sum before xw is added, as (h . Uq) * s; h is
// never quantized.  Row-compacted U (`rows` given) holds only the Ha rows
// whose 8-row tiles are not all zero; the product runs over those rows
// with h gathered through the row index (in shared memory), and padding
// rows are zero U rows at index 0 that add exactly 0.0.
//
// Numerics as the reference's: U is upcast to fp32 before the product and
// accumulated in fp32; h and c are carried in fp32 between steps and h is
// rounded to h0's dtype only where it is stored (hs, h_T), so block_t (a
// planning parameter) cannot change the result.

#include "seq_cluster.cuh"

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// U (G, Hr, 4, H) with Hr = H, or Hr = Ha rows when `rows` is given;
// scales (G, 4) fp32 or NULL; rows (G, Ha) int32 or NULL; xw (G, B, T, 4,
// H); h0 (G, B, H); c0 (G, B, H) fp32; mask (G, B) int32 or NULL; outputs
// hs (G, B, T, H) and hT (G, B, H) in h0's dtype, cT (G, B, H) fp32.
// u_type picks U's type (0 fp32, 1 bf16, 2 int8, which comes with
// scales); *_bf16 flags pick bfloat16 over fp32 for xw and h.  Launches
// on `stream` and returns the CUDA error (0 = ok; anything else is a
// refused launch: a shape past the kernel's limits, H > 2048, a cluster
// the card cannot hold).
extern "C" int lstm_seq_launch(const void* U, const void* scales,
                               const void* rows, const void* xw,
                               const void* h0, const void* c0,
                               const void* mask, void* hs, void* hT,
                               void* cT, int G, int B, int T, int H, int Hr,
                               int u_type, int xw_bf16, int h_bf16,
                               void* stream) {
  const seq::Args a{U, static_cast<const float*>(scales),
                    static_cast<const int*>(rows), xw, h0,
                    static_cast<const float*>(c0),
                    static_cast<const int*>(mask), hs, hT,
                    static_cast<float*>(cT), G, B, T, H, Hr, u_type,
                    xw_bf16, h_bf16, static_cast<cudaStream_t>(stream)};
  return seq::launch<rnn::LstmCell>(a);
}

// What a launch at (B, H, Hr, u_type) takes, without launching
// (seq::query): out[0..4] = cluster size S, batch rows a cluster, ring
// bytes a CTA (0: U resident), shared memory a CTA, clusters the card
// holds at once.
extern "C" int lstm_seq_shape(int B, int H, int Hr, int u_type, int* out) {
  return seq::query<rnn::LstmCell>(B, H, Hr, u_type, out);
}
