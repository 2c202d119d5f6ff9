// The GEMM with a LayerNorm prologue: out = epilogue(bf16(LN(x)) @ W).
//
// Replaces, in ops/pallas_layer.py::_layer_kernel, each `_ln` whose output
// only feeds the next `_mm` (the macaron FFs' intermediate dense, the fused
// QKV with its second bias, cgMLP's channel_proj1), and in
// ops/pallas_subsample.py::_subsample_kernel the LayerNorm in front of the
// projection: on the TPU `_ln` runs inside the kernel and its output stays in
// VMEM. The port's standalone LayerNorm (layer.cu) wrote that operand to
// device memory and the GEMM read it back, two launches; here one kernel
// (gemm.cuh, gemm_ln_kernel) loads a block's raw A row tile once into shared
// memory, normalises it there and streams the weight's column tiles past it:
// one launch, and the normalised tensor never exists. What bounds it on the
// H100 is what bounds the GEMM (gemm.cuh's note), less the LayerNorm's own
// pass over the rows and its bf16 output.
//
// The operand is layernorm_kernel's bits (common.cuh's ln_* steps, the same
// order of sums), so the outputs are those of asr_layernorm_bf16 followed by
// asr_gemm_bf16: the same tiles, products and epilogue.
#include "gemm.cuh"

// x: [M, ldx] bf16 raw rows (LN over their K columns); g, b: [K] fp32; w: [K,
// ldw] bf16; the epilogue of asr_gemm_bf16 without a residual: bias, act,
// round_first, and the second output out2 = bf16(acc + bias2) of the first n2
// columns (bias2 null: none).
ASR_API int asr_gemm_ln_bf16(const void* x, const void* g, const void* b, float eps, const void* w,
                             const void* bias, const void* bias2, void* out, void* out2, int M, int N, int K,
                             int ldx, int ldw, int ldo, int ldo2, int n2, int act, int round_first, void* stream) {
    if (g == nullptr || b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    gemm::Epilogue e;
    e.bias = static_cast<const float*>(bias);
    e.bias2 = static_cast<const float*>(bias2);
    e.out = static_cast<bf16*>(out);
    e.out2 = static_cast<bf16*>(out2);
    e.res = nullptr;
    e.ldo = ldo;
    e.ldo2 = ldo2;
    e.ldr = 0;
    e.n2 = n2;
    e.alpha = 1.0f;
    e.act = act;
    e.round_first = round_first;
    e.gate = 0;
    gemm::Norm nm;
    nm.g = static_cast<const float*>(g);
    nm.b = static_cast<const float*>(b);
    nm.eps = eps;
    return gemm::launch_ln(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(w), ldw, M, N, K, e, nm,
                           static_cast<cudaStream_t>(stream));
}
