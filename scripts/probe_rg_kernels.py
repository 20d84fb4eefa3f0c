"""First check of the RecurrentGemma slice's two new kernel instantiations.

Builds ``rg_lru`` and ``flash_attention`` from ``src/repro_torch/csrc``
(printing ptxas' register and spill lines), holds ``rg_lru`` against its
plain version at small shapes and at recurrentgemma-2b's prefill shape
(4, 2000, 2560), holds ``flash_attention`` at head_dim 256 against its plain
version (the prefill shape, a binding window at S 4096, and GQA at S 130),
and times both kernels and ``scaled_dot_product_attention`` with CUDA
events.  Needs one CUDA card; run from the repo root:

    python3 scripts/probe_rg_kernels.py
"""
import sys, time, json
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build, ops, ref
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.time()
b = _build.build(["rg_lru", "flash_attention"])
for n, r in b.items():
    print(n, r["seconds"])
    for l in r["log"].splitlines():
        if "registers" in l or "spill" in l or "error" in l.lower():
            print("  ", l.strip())
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
for (B, S, W) in [(1, 64, 16), (2, 70, 32), (1, 256, 8), (4, 2000, 2560)]:
    for dt in (torch.float32, torch.bfloat16):
        a = torch.sigmoid(torch.randn(B, S, W, generator=g, device=dev)).to(dt)
        gx = (torch.randn(B, S, W, generator=g, device=dev) * 0.4).to(dt)
        y = ops.rg_lru_scan(a, gx)
        w = ref.rg_lru_ref(a, gx)
        torch.cuda.synchronize()
        print("rg_lru", (B, S, W), dt, "equal", torch.equal(y, w), float((y - w).abs().max()))
def cms(fn, n=5):
    fn(); torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n): fn()
    e.record(); torch.cuda.synchronize()
    return s.elapsed_time(e) / n
a = torch.rand(4, 2000, 2560, device=dev); gx = torch.randn(4, 2000, 2560, device=dev)
print("rg_lru ms", cms(lambda: ops.rg_lru_scan(a, gx)))
for (B, H, K, S, d, win) in [(4, 10, 1, 2000, 256, 2048), (1, 10, 1, 4096, 256, 2048), (1, 4, 2, 130, 256, None)]:
    for dt in (torch.float32, torch.bfloat16):
        mk = lambda n, h, std: (torch.randn(B, n, h, d, generator=g, device=dev) * std).to(dt).transpose(1, 2)
        q, k, v = mk(S, H, 1.5), mk(S, K, 1.5), mk(S, K, 0.4)
        o = ops.flash_attention(q, k, v, causal=True, window=win)
        w = ref.flash_attention_ref(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        print("flash", (B, H, K, S, d, win), dt, float((o.float() - w.float()).abs().max()),
              bool(torch.allclose(o.float(), w.float(), rtol=2e-5 if dt == torch.float32 else 1e-2, atol=2e-5 if dt == torch.float32 else 1e-4)))
        if S == 2000 and dt == torch.bfloat16:
            print("flash ms", cms(lambda: ops.flash_attention(q, k, v, causal=True, window=win)),
                  "sdpa ms", cms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)))
print("wall", time.time() - t0)
