"""Fixed benchmark sweep shapes (the port's own copy of
``param_tpu/ops/datasets.py``, kept equal to it by
``tests/test_torch_compute.py``).

Benchmark-configuration data reproduced from PARAM
(``train/compute/pt/dataset.py:7-98``) so results are directly comparable.
These are the DLRM-representative shape sets PARAM publishes its example
numbers on.
"""

# gemm tuple shape (M, N, K)
GEMM_A = [
    (128, 4096, 4096), (256, 4096, 4096), (512, 4096, 4096), (1024, 4096, 4096),
    (128, 1024, 1024), (256, 1024, 1024), (512, 1024, 1024), (1024, 1024, 1024),
    (4096, 4096, 128), (4096, 4096, 256), (4096, 4096, 512), (4096, 4096, 1024),
    (1024, 1024, 128), (1024, 1024, 256), (1024, 1024, 512),
]

GEMM_B = [
    (128, 4096, 40928), (256, 4096, 40928), (512, 4096, 40928), (1024, 4096, 40928),
    (128, 40928, 4096), (256, 40928, 4096), (512, 40928, 4096), (1024, 40928, 4096),
    (128, 1024, 2000), (256, 1024, 2000), (512, 1024, 2000), (1024, 1024, 2000),
    (1024, 2000, 128), (1024, 2000, 256), (1024, 2000, 512), (1024, 2000, 1024),
    (4096, 40928, 128), (4096, 40928, 256), (4096, 40928, 512), (4096, 40928, 1024),
]

GEMM_C = [
    (1024, 1024, 64), (1024, 64, 1024), (1024, 4096, 1024), (1024, 1024, 4096),
]

# emb tuple (rows, embdim, nnz, batch)
EMB_A = [
    (14_000_000, 128, 30, b)
    for b in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
] + [
    (26_000_000, 128, 30, b)
    for b in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
]

EMB_B = [
    (4_800_000, 56, 34, b) for b in (2048, 4096, 8192, 16384, 32768, 65536)
]

# the single-chip config of BASELINE.json
EMB_BASELINE = [(1_000_000, 128, 30, 8192)]

# mlp tuple (layer-num, input-size, hidden-size, output-size, batch-size)
MLP_A = [
    (18, 1024, 1024, 1024, b) for b in (128, 256, 512, 1024, 2048, 4096)
] + [
    (18, 4096, 4096, 4096, b) for b in (128, 256, 512, 1024, 2048, 4096)
]

# attention tuple (batch, heads, seq, head-dim) — beyond-reference tier for
# the transformer workloads the ET replayer ingests (hf_GPT2 fixture heads
# config; llama2 rows match the LLaMA-2-7B GEMM configs already in
# RESULTS.md).  Self-attention (S_q == S_k); decode (S_q=1) is a
# memory-bound gather problem, covered by the embedding tier instead.
ATTN_GPT2 = [(b, 12, 1024, 64) for b in (1, 8, 32)]
ATTN_LLAMA2 = [(1, 32, 2048, 128), (1, 32, 4096, 128), (4, 32, 2048, 128)]

# transformer-block tuple (batch, seq, emb, heads, ffn) — pre-LN block
# train-step bench (cli.compute transformer).  gpt2 matches the hf_GPT2
# ET fixture config (E=768, 12 heads of 64, ff=3072); gpt2-medium is the
# 350M-class block; llama2 matches the LLaMA-2-7B dims whose projection
# GEMMs are already measured in RESULTS.md (reference shape source:
# train/compute/python llama2 config).
TRANSFORMER_GPT2 = [(8, 1024, 768, 12, 3072)]
TRANSFORMER_GPT2_MEDIUM = [(4, 1024, 1024, 16, 4096)]
TRANSFORMER_LLAMA2 = [(1, 2048, 4096, 32, 11008)]

DATASETS = {
    "A": GEMM_A, "B": GEMM_B, "C": GEMM_C,
}

GEMM_DATASETS = {"A": GEMM_A, "B": GEMM_B, "C": GEMM_C}
ATTN_DATASETS = {"gpt2": ATTN_GPT2, "llama2": ATTN_LLAMA2}
EMB_DATASETS = {"A": EMB_A, "B": EMB_B, "baseline": EMB_BASELINE}
MLP_DATASETS = {"A": MLP_A}
# decode tuple (batch, heads, kv_len, head_dim) — serving decode step
# (one query token vs the KV cache; memory-bound, GB/s metric)
DECODE_LLAMA2 = [(1, 32, 2048, 128), (8, 32, 2048, 128),
                 (32, 32, 2048, 128), (8, 32, 8192, 128)]
DECODE_GPT2 = [(8, 12, 1024, 64), (64, 12, 1024, 64)]
# GQA 5-tuple (batch, heads, kv_heads, kv_len, head_dim): llama-3-8B is
# 32 q heads over 8 kv heads — the cache (and traffic) shrinks 4x
DECODE_LLAMA3 = [(8, 32, 8, 2048, 128), (32, 32, 8, 2048, 128),
                 (8, 32, 8, 8192, 128)]
DECODE_DATASETS = {"llama2": DECODE_LLAMA2, "gpt2": DECODE_GPT2,
                   "llama3-gqa": DECODE_LLAMA3}

# serve tuple (batch, cache_len, emb, heads, ffn): whole-block decode
SERVE_LLAMA2 = [(1, 2048, 4096, 32, 11008), (8, 2048, 4096, 32, 11008),
                (32, 2048, 4096, 32, 11008)]
SERVE_GPT2 = [(8, 1024, 768, 12, 3072), (64, 1024, 768, 12, 3072)]
# llama-3-8B block geometry: 32 q heads over 8 kv heads (GQA)
SERVE_LLAMA3 = [(1, 2048, 4096, 32, 8, 14336), (8, 2048, 4096, 32, 8, 14336),
                (32, 2048, 4096, 32, 8, 14336)]
SERVE_DATASETS = {"llama2": SERVE_LLAMA2, "gpt2": SERVE_GPT2,
                  "llama3-gqa": SERVE_LLAMA3}

TRANSFORMER_DATASETS = {
    "gpt2": TRANSFORMER_GPT2,
    "gpt2-medium": TRANSFORMER_GPT2_MEDIUM,
    "llama2": TRANSFORMER_LLAMA2,
    "all": TRANSFORMER_GPT2 + TRANSFORMER_GPT2_MEDIUM + TRANSFORMER_LLAMA2,
}
