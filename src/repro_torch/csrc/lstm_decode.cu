// lstm_decode: one T=1 decode tick through all L layers of an LSTM stack
// in ONE launch: a thread-block cluster per batch row that spreads each
// layer's hidden units over up to 16 SMs.
//
// Replaces the TPU kernel lstm_decode_pallas / _decode_kernel
// (src/repro/kernels/lstm_cell/kernel.py:337 / :279).  Same function:
// layer 0 takes the hoisted input half xw0; layer l > 0 computes its input
// half y . W_l + b_l from the previous layer's fresh output y, then the
// cell against (h0[l], c0[l]).  Outputs h_n (L, B, H) in h0's dtype and
// c_n (L, B, H) fp32.  Rounding points as in the reference (kernel.py:
// 314-319, :332): see decode_cluster.cuh.
//
// What bounds it on an H100: bytes.  A tick reads 2L - 1 weight matrices
// of H x 4H (W_0 is never needed), each once, and does 8 B H^2 FMAs per
// matrix.  The least time, at 3.35 TB/s: BYSDNE (L = 5, H = 340, bf16
// weights, fp32 state) 8.46 MB, 0.002527 ms at B = 4; RLDRADSPR's width
// (L = 10, H = 1024, bf16) 160.2 MB, 0.0478 ms.  BYSDNE's 8.5 MB stay in
// the 50 MB L2 between serving ticks; RLDRADSPR's 160 MB cannot.  The
// layers are a serial chain, so a tick cannot spread over the card's 132
// SMs the way a GEMV does: the previous design ran a whole tick in one
// 512-thread block on one SM.
//
// The design (decode_cluster.cuh): the S CTAs of a cluster (16 at H = 340
// and 1024; from (H, 4) alone, kernels.common.decode_splits) each own a
// contiguous slice of hidden units with all four gate columns, so the cell
// update and c stay in the CTA and no partial sum crosses CTAs.  Each CTA
// streams its slice of every U and W through a per-thread cp.async ring
// that runs ahead across layers; U_l . h0[l] (known at launch) is computed
// before the wait for the previous layer's y, which arrives through
// distributed shared memory with one cluster barrier per layer.  Each
// batch row has its own cluster: with up to 4 rows in one cluster a B = 4
// tick was slower, since 4 rows quadruple each CTA's FMAs, while with a
// cluster a row the other rows' clusters read the same weights from L2
// and a B = 4 tick takes a B = 1 tick's time.
//
// Split and alignment: slices start on multiples of 8 units when H % 8 ==
// 0 (16-byte loads of 8 bf16), of 4 when H % 4 == 0 (8-byte loads of bf16,
// 16-byte of fp32; H = 340 is 42.5 x 8, so its bf16 gate segments, 680
// bytes apart, are only 8-byte aligned), else of 1 (plain loads).
//
// What was tried and did not help (exploratory builds, timed on the card
// in graphs of chained ticks): 4-row groups per cluster (slower at B = 4,
// above); the tensor cores (mma.sync m16n8k16, the fp32 activations as
// three exact bf16 planes) fed from a CTA-wide ring of k-row chunks (one
// CTA barrier a chunk held the stream back) or from per-warp streams of
// 8-column strips (16-byte pieces of many rows: uncoalesced) -- both
// slower than the CUDA-core stream; arriving on the cluster barrier after
// the next layer's U product instead of right after the push; a 128 KB
// ring (faster at H = 1024, not at H = 340).  A clock profile of one tick
// puts most of a layer in its two products, whose per-row instruction
// count (issue, unpack, FMAs) the CUDA cores are bound by.
//
// Operand forms: W (and b) bf16 or fp32; U in W's type or, under bf16 W,
// fp32 (the fake-quantized U of a bf16 stack under a reduced recurrent-
// weight precision); xw0 and h0/h_n fp32 or bf16; c fp32; any B (a
// cluster a row, 7 resident at once at S = 16); H <= 2048.

#include "decode_cluster.cuh"

namespace lstm {

struct LstmCell {
  static constexpr int G = 4;
  static constexpr bool kHasC = true;
  // gate order i, f, g, o; returns h (fp32), c through `c`
  __device__ static float update(const float (&xw)[4], const float (&hu)[4],
                                 float, float c_prev, float& c) {
    const float i_g = rnn::sigmoid(xw[0] + hu[0]);
    const float f_g = rnn::sigmoid(xw[1] + hu[1]);
    const float g_g = tanhf(xw[2] + hu[2]);
    const float o_g = rnn::sigmoid(xw[3] + hu[3]);
    c = f_g * c_prev + i_g * g_g;
    return o_g * tanhf(c);
  }
};

}  // namespace lstm

// Plain C entry points (bound with ctypes).  Layouts, all contiguous:
// xw0 (B, 4, H); Ws (L, H, 4, H) and bs (L, 4, H) in one dtype; Us
// (L, H, 4, H) in Ws's dtype or, under bf16 Ws, fp32; h0 (L, B, H); c0
// (L, B, H) fp32; outputs hn (L, B, H) in h0's dtype and cn (L, B, H)
// fp32.  *_bf16 flags pick bfloat16 over fp32 per operand (fp32 Ws with
// bf16 Us is refused: the wrapper upcasts such a U).  Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int lstm_decode_launch(const void* xw0, const void* Ws,
                                  const void* bs, const void* Us,
                                  const void* h0, const void* c0, void* hn,
                                  void* cn, int L, int B, int H, int w_bf16,
                                  int u_bf16, int xw_bf16, int h_bf16,
                                  void* stream) {
  const decode::Args a{xw0, Ws, bs, Us, h0, c0, hn, cn, L, B, H, w_bf16,
                       u_bf16, xw_bf16, h_bf16,
                       static_cast<cudaStream_t>(stream)};
  return decode::launch<lstm::LstmCell>(a);
}

// The cluster size and occupancy query (decode::occupancy).
extern "C" int lstm_decode_clusters(int B, int H, int w_bf16, int u_bf16,
                                    int* splits, int* clusters) {
  return decode::occupancy<lstm::LstmCell>(B, H, w_bf16, u_bf16, splits,
                                           clusters);
}
