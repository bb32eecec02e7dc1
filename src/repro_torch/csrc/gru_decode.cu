// gru_decode: one T=1 decode tick through all L layers of a GRU stack in
// ONE launch: a thread-block cluster per batch row that spreads each
// layer's hidden units over up to 16 SMs.
//
// Replaces the TPU kernel gru_decode_pallas / _decode_kernel
// (src/repro/kernels/gru_cell/kernel.py:217 / :176).  Same function:
// layer 0 takes the hoisted input half xw0; layer l > 0 computes its input
// half y . W_l + b_l from the previous layer's fresh output y, then the GRU
// cell against h0[l].  Output h_n (L, B, H) in h0's dtype; no cell state.
// Rounding points as in the reference (kernel.py:192-214): see
// decode_cluster.cuh; besides, h = (1 - z) * n + z * h0[l] with h0[l] read
// in its stored dtype.
//
// What bounds it on an H100: bytes.  A tick reads 2L - 1 weight matrices
// of H x 3H (W_0 is never needed), each once.  The least time, at 3.35
// TB/s: BYSDNE (L = 5, H = 340, bf16 weights, fp32 state) 6.32 MB,
// 0.001887 ms at B = 4; RLDRADSPR's width (L = 10, H = 1024, bf16) 120.0
// MB, 0.0358 ms.
//
// The design is lstm_decode.cu's (decode_cluster.cuh) with three gates:
// a cluster a batch row, whose S CTAs (16 at H = 340 and 1024;
// kernels.common.decode_splits(H, 3)) each own a contiguous slice of
// hidden units with its z, r and n columns, so the reset gate's coupling
// n = tanh(xw_n + r * (U_n h)) stays inside the CTA: the raw U_n h is kept
// apart from the input half until r is known.  The same split and
// alignment rule: slices on multiples of 8 units when H % 8 == 0, of 4
// when H % 4 == 0, else of 1 (plain loads; the H = 50 case of the kernels
// phase).  What was tried and did not help: see lstm_decode.cu.
//
// Operand forms as lstm_decode's: W (and b) bf16 or fp32; U in W's type
// or, under bf16 W, fp32; xw0 and h0/h_n fp32 or bf16; any B; H <= 2048.

#include "decode_cluster.cuh"

namespace gru {

struct GruCell {
  static constexpr int G = 3;
  static constexpr bool kHasC = false;
  // gate order z, r, n; returns h (fp32)
  __device__ static float update(const float (&xw)[3], const float (&hu)[3],
                                 float h_prev, float, float&) {
    const float z = rnn::sigmoid(xw[0] + hu[0]);
    const float rg = rnn::sigmoid(xw[1] + hu[1]);
    const float n = tanhf(xw[2] + rg * hu[2]);
    return (1.f - z) * n + z * h_prev;
  }
};

}  // namespace gru

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// xw0 (B, 3, H); Ws (L, H, 3, H) and bs (L, 3, H) in one dtype; Us
// (L, H, 3, H) in Ws's dtype or, under bf16 Ws, fp32; h0 (L, B, H);
// output hn (L, B, H) in h0's dtype.  *_bf16 flags pick bfloat16 over
// fp32 per operand (fp32 Ws with bf16 Us is refused: the wrapper upcasts
// such a U).  Launches on `stream` and returns cudaGetLastError() (0 =
// ok).
extern "C" int gru_decode_launch(const void* xw0, const void* Ws,
                                 const void* bs, const void* Us,
                                 const void* h0, void* hn, int L, int B,
                                 int H, int w_bf16, int u_bf16, int xw_bf16,
                                 int h_bf16, void* stream) {
  const decode::Args a{xw0, Ws, bs, Us, h0, nullptr, hn, nullptr, L, B, H,
                       w_bf16, u_bf16, xw_bf16, h_bf16,
                       static_cast<cudaStream_t>(stream)};
  return decode::launch<gru::GruCell>(a);
}

// The cluster size and occupancy query (decode::occupancy).
extern "C" int gru_decode_clusters(int B, int H, int w_bf16, int u_bf16,
                                   int* splits, int* clusters) {
  return decode::occupancy<gru::GruCell>(B, H, w_bf16, u_bf16, splits,
                                         clusters);
}
