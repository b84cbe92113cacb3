"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines print):

1. the card's name and power limit (``nvidia-smi``); TF32 off;
2. build every kernel of the serving path from ``singa_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, in parallel);
3. flash-attention forward: kernel against its plain PyTorch version at
   the serving shape (dense mask, q (1,12,64,64), k/v (1,12,1024,64)),
   plus causal and key-vector cases, and ragged T/S cases at every head
   dim the kernel is built for (per-head masks, a fully masked row);
   times at the serving shape for kernel, plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
4. paged decode attention: kernel against its plain version at the
   serving shape (8 slots, 12 heads, d 64, 16-token pages, 64 pages a
   slot, NULL tails, mid-page positions), plus 8-, 12- and 32-token
   pages at head dims 64, 32 and 128;
5. the slice: the paged, chunked ``ServingEngine`` on GPT-2-small
   dimensions (fp32, seeded random weights carried in through
   ``GPT.from_jax_decode_params``) serves 8 staggered requests (one
   sampled, the rest greedy); the kernels' launch counters are zeroed
   just before and read just after; two greedy requests are replayed
   through the port on the CPU and their tokens compared;
6. one ``kernels`` JSON line, then the result line.

    python3 chip_smoke.py --profile

runs phases 1-2 and then the phase-5 stream once under ``torch.profiler``
(CPU and CUDA activity) and prints the device's busy and idle share over
the run, device time by kernel group and the costliest kernels.

Kernel times are the median of single launches timed with CUDA events,
each after a 64 MiB write that evicts the 50 MB L2, so K/V come from
device memory as on the serving path.  ``bound_ms`` is the larger of
bytes moved (each input read once, each output written once) over
3.35 TB/s and float32 operations over 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from singa_tpu_torch.models import gpt as tgpt  # noqa: E402
from singa_tpu_torch.ops import _build  # noqa: E402
from singa_tpu_torch.ops import flash_attention as fa  # noqa: E402
from singa_tpu_torch.ops import paged_attention as pa  # noqa: E402
from singa_tpu_torch.serving import ServingEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FLASH_TOL = 1e-4
PAGED_TOL = 1e-4
MARGIN_TOL = 1e-3
REPS = 30

# serving configuration of phase 5 (GPT-2-small widths, 12 layers)
N_SLOTS, PAGE, CHUNK, HORIZON, NEW = 8, 16, 64, 8, 32


def _log(msg):
    print(msg, flush=True)


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_FLUSH = None


def _time_ms(fn, reps=REPS):
    """Median single-launch time of ``fn`` in ms, L2 evicted before
    each launch."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phase_card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    card = r.stdout.strip().splitlines()[0]
    _log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    t0 = time.perf_counter()
    built = _build.build()
    _log(f"build: {time.perf_counter() - t0:.2f}s wall, per library "
         + json.dumps({k: round(v, 2) for k, v in built.items()}))
    for name in _build.SOURCES:
        report = " | ".join(line.strip() for line in
                            _build.ptxas_report(name).splitlines()
                            if "registers" in line or "spill" in line)
        _log(f"ptxas {name}: {report}")


def phase_flash():
    """Kernel vs plain version; returns the row for the kernels line
    (numbers at the serving shape)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    H, d, C, L = 12, 64, 64, 1024
    scale = 1.0 / np.sqrt(d)
    # serving shape: a 64-token chunk at positions 512..575 of a
    # 1024-column page row, the (C, L) mask col <= position
    q, k, v = rnd(1, H, C, d), rnd(1, H, L, d), rnd(1, H, L, d)
    positions = 512 + torch.arange(C, device="cuda")
    cols = torch.arange(L, device="cuda")
    mask = torch.where(cols[None] <= positions[:, None], 0.0, -1e9)
    mask = mask[None, None].contiguous()
    cases = {"dense(serving)": (q, k, v, mask, False)}
    qc, kc, vc = rnd(1, H, 512, d), rnd(1, H, 512, d), rnd(1, H, 512, d)
    cases["causal"] = (qc, kc, vc, None, True)
    vec = torch.zeros(1, 1, 1, L, device="cuda")
    vec[..., 900:] = -1e9
    cases["vec"] = (q, k, v, vec, False)
    # every head dim the kernel is built for, at ragged T/S (the
    # reference's closed-form key padding), with per-head masks and a
    # fully masked row
    for dd, (B, Hh, T, S), causal in ((16, (2, 3, 70, 200), False),
                                      (32, (2, 2, 33, 77), False),
                                      (128, (1, 2, 150, 150), True)):
        m = torch.where(torch.rand(B, Hh, T, S, generator=g, device="cuda")
                        < 0.2, -1e9, 0.0)
        m[-1, -1, T // 2] = -1e9
        cases[f"ragged d{dd} per-head"] = (
            rnd(B, Hh, T, dd), rnd(B, Hh, S, dd), rnd(B, Hh, S, dd), m,
            causal)
    vb = torch.zeros(2, 1, 1, 77, device="cuda")
    vb[1, ..., 60:] = -1e9
    cases["ragged d32 per-batch vec"] = (
        rnd(2, 2, 33, 32), rnd(2, 2, 77, 32), rnd(2, 2, 77, 32), vb, False)
    err_serving = None
    for name, (a, b, c, m, causal) in cases.items():
        got = fa.flash_attention(a, b, c, m, causal=causal)
        ref = fa.flash_attention_reference(a, b, c, m, causal=causal)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= FLASH_TOL
        _log(f"flash {name}: max_abs_err {err:.3e} (tol {FLASH_TOL:g}) "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash {name} disagrees with its plain "
                                 f"version: {err}")
        if err_serving is None:
            err_serving = err
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, mask, sm_scale=scale))
    plain_ms = _time_ms(lambda: fa.flash_attention_reference(
        q, k, v, mask, sm_scale=scale))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale))
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + mask.numel()
                  + q.numel() + H * C)          # q,k,v,mask in; o,lse out
    flops = 4 * H * C * L * d                   # two products, 2 flop/FMA
    bound_ms, bound_by = _bound(nbytes, flops)
    _log(f"flash serving shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
         f" sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
         f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "replaces": "singa_tpu/ops/pallas_kernels.py:102",
            "max_abs_err": err_serving, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _paged_case(seed, S, H, d, P, Ps, pos_h):
    """Random pools of ``S * Ps + 1`` pages; each slot's table holds
    distinct pages up to its position and NULL (page 0) after it."""
    N = S * Ps + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(S, H, d, generator=g, device="cuda")
    kp = torch.randn(N, H, P, d, generator=g, device="cuda")
    vp = torch.randn(N, H, P, d, generator=g, device="cuda")
    pos_h = np.asarray(pos_h, np.int32)
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, N)))
    table_h = np.zeros((S, Ps), np.int32)
    for s in range(S):
        n = pos_h[s] // P + 1
        table_h[s, :n] = [free.pop() for _ in range(n)]
    return (q, kp, vp, torch.from_numpy(table_h).cuda(),
            torch.from_numpy(pos_h).cuda())


def phase_paged():
    S, H, d, P, Ps = N_SLOTS, 12, 64, PAGE, 1024 // PAGE
    pos_h = np.array([100, 257, 511, 30, 700, 1023, 5, 300], np.int32)
    cases = {"serving": _paged_case(1, S, H, d, P, Ps, pos_h)}
    # other page sizes and head dims, positions on and off page edges
    for seed, (dd, PP, pp) in enumerate(((64, 8, [7, 8, 0, 250]),
                                         (32, 12, [11, 12, 131, 0]),
                                         (128, 32, [31, 32, 500, 1]))):
        cases[f"d{dd} P{PP}"] = _paged_case(2 + seed, len(pp), 4, dd, PP,
                                            -(-512 // PP), pp)
    err_serving = None
    for name, args in cases.items():
        got = pa.paged_decode_attention(*args)
        ref = pa.paged_decode_attention_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= PAGED_TOL
        _log(f"paged decode {name}: max_abs_err {err:.3e} (tol "
             f"{PAGED_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged decode {name} disagrees with its "
                                 f"plain version: {err}")
        if err_serving is None:
            err_serving = err
    q, kp, vp, table, pos = cases["serving"]
    ms = _time_ms(lambda: pa.paged_decode_attention(q, kp, vp, table, pos))
    plain_ms = _time_ms(lambda: pa.paged_decode_attention_reference(
        q, kp, vp, table, pos))
    live_pages = int((pos_h // P + 1).sum())
    live_cols = int((pos_h + 1).sum())
    nbytes = 4 * (2 * q.numel() + S * Ps + S) \
        + 2 * live_pages * H * P * d * 4        # live K and V pages
    flops = 4 * H * d * live_cols
    bound_ms, bound_by = _bound(nbytes, flops)
    _log(f"paged decode serving shape: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
         f"{nbytes / 1e6:.2f} MB over {live_pages} live pages)")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": "singa_tpu/ops/paged_attention.py:45",
            "max_abs_err": err_serving, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _requests(cfg):
    """8 prompts of 100-300 tokens; requests 1 and 6 share a 64-token
    prefix."""
    rng = np.random.RandomState(7)
    lens = rng.randint(100, 301, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    prompts[6][:64] = prompts[1][:64]
    return prompts


def _cpu_margin(cpu_model, tokens):
    """Top-2 logit margin at the end of ``tokens``, from the port's
    plain path on the CPU (one chunk over fresh pages)."""
    cfg = cpu_model.config
    params = cpu_model.decode_params()
    H, D = cfg.n_heads, cfg.d_model
    T = len(tokens)
    n_pages = -(-T // PAGE)
    pages = [(torch.zeros(n_pages + 1, H, PAGE, D // H),
              torch.zeros(n_pages + 1, H, PAGE, D // H))
             for _ in range(cfg.n_layers)]
    row = torch.arange(1, n_pages + 1, dtype=torch.int32)
    positions = torch.arange(T)
    ids = torch.from_numpy(np.asarray(tokens, np.int32))[None]
    with torch.no_grad():
        h = tgpt._embed(params, ids, positions, cfg.use_rope)
        for bp, (kp, vp) in zip(params["blocks"], pages):
            h, _, _ = tgpt._block_chunk_prefill_paged(
                bp, h, kp, vp, row, positions, H, 1.0 / np.sqrt(D // H))
        lg = tgpt._logits(params, h[:, -1:])[0, 0]
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def _serve(eng, prompts):
    """The staggered stream: four requests, two steps, four more, run to
    the end.  Request 3 samples (temperature 0.8, top-k 40) from its own
    generator; the rest are greedy.  Returns ``(rids, results)``."""
    sampling = [dict(temperature=0.8, top_k=40, seed=3) if i == 3 else {}
                for i in range(len(prompts))]
    rids = [eng.submit(p, NEW, **kw_i)
            for p, kw_i in zip(prompts[:4], sampling[:4])]
    eng.step()
    eng.step()
    rids += [eng.submit(p, NEW, **kw_i)
             for p, kw_i in zip(prompts[4:], sampling[4:])]
    return rids, eng.run()


def _slice_setup():
    """GPT-2-small widths with seeded weights on the card, the engine
    arguments and the prompts; one short warm-up run (cuBLAS handles,
    allocator) on an engine of its own."""
    cfg = tgpt.GPTConfig.small()
    tree = tgpt.seeded_decode_params(cfg, seed=0)
    model = tgpt.GPT.from_jax_decode_params(tree, cfg)      # on the card
    kw = dict(n_slots=N_SLOTS, page_tokens=PAGE, chunk_tokens=CHUNK,
              decode_horizon=HORIZON)
    prompts = _requests(cfg)
    warm = ServingEngine(model, **kw)
    warm.submit(prompts[0][:80], 9)
    warm.run()
    torch.cuda.synchronize()
    return cfg, tree, model, kw, prompts


def phase_slice():
    cfg, tree, model, kw, prompts = _slice_setup()
    eng = ServingEngine(model, **kw)
    fa.launches = 0
    pa.launches = 0
    t0 = time.perf_counter()
    rids, res = _serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "paged_decode_attention": pa.launches}
    snap = eng.metrics.snapshot()
    _log("slice launches " + json.dumps(launches))
    _log(f"slice: {len(res)} requests in {wall:.3f}s; "
         f"ttft_p50_ms {snap['ttft_p50_ms']} itl_p50_ms {snap['itl_p50_ms']}"
         f" itl_p99_ms {snap['itl_p99_ms']} tokens_per_s "
         f"{snap['tokens_per_s']} prefix_cache_hit_rate "
         f"{snap['prefix_cache_hit_rate']} host_syncs_per_token "
         f"{snap['host_syncs_per_token']} uploads_per_token "
         f"{snap['uploads_per_token']}")
    _log("slice metrics " + json.dumps(snap))
    if len(res) != len(prompts):
        raise AssertionError(f"{len(res)} of {len(prompts)} requests "
                             f"completed")
    for r in rids:
        toks = res[r]
        if toks.shape != (NEW,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r}: bad tokens {toks}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"serving path")
    if snap["prefix_cache_hit_rate"] <= 0:
        raise AssertionError("the shared 64-token prefix was not reused")

    # oracle: the prefix-sharing pair through the port on the CPU
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = tgpt.GPT.from_jax_decode_params(tree, cfg, device="cpu")
    ceng = ServingEngine(cpu_model, device="cpu", **dict(kw, n_slots=2))
    pair = [1, 6]
    crids = [ceng.submit(prompts[i], NEW) for i in pair]
    cres = ceng.run()
    for i, cr in zip(pair, crids):
        a, b = res[rids[i]], cres[cr]
        if np.array_equal(a, b):
            _log(f"oracle request {i}: {NEW} greedy tokens identical to "
                 f"the CPU run")
            continue
        j = int(np.flatnonzero(a != b)[0])
        margin = _cpu_margin(cpu_model, np.concatenate([prompts[i], a[:j]]))
        _log(f"oracle request {i}: first difference at token {j}, CPU "
             f"top-2 logit margin {margin:.3e}")
        if margin >= MARGIN_TOL:
            raise AssertionError(f"request {i} differs from the CPU run at "
                                 f"token {j} with margin {margin}")
    return launches, snap


def _kernel_bucket(name):
    if "flash_fwd" in name:
        return "flash_attention_fwd kernel"
    if "paged_decode" in name:
        return "paged_decode kernel"
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "cublas")):
        return "matmuls (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies and fills"
    return "other kernels (elementwise, reductions, indexing)"


def phase_profile():
    """The slice's stream once more, under ``torch.profiler`` (CPU and
    CUDA activity): device busy and idle share over the run, device time
    by kernel group and by kernel, kernels launched per decode
    iteration.  Times under the profiler include its own overhead on the
    host."""
    from torch.profiler import ProfilerActivity, profile
    cfg, _, model, kw, prompts = _slice_setup()
    eng = ServingEngine(model, **kw)
    fa.launches = 0
    pa.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _serve(eng, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_type = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    kern = [e for e in events if e.device_type == dev_type
            and e.time_range.end > e.time_range.start]
    if not kern:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    groups, names = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        for d, key in ((groups, _kernel_bucket(e.name)), (names, e.name)):
            n, t = d.get(key, (0, 0.0))
            d[key] = (n + 1, t + us)
    iters = pa.launches // cfg.n_layers
    _log(f"profile: host wall {wall:.3f}s; profiled window "
         f"{window / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
         f"share {1 - busy / window:.4f}; {len(kern)} device activities, "
         f"{iters} decode iterations, {fa.launches} flash / {pa.launches} "
         f"paged launches")
    for key, (n, t) in sorted(groups.items(), key=lambda x: -x[1][1]):
        _log(f"profile group {key}: {n} activities, {t / 1e3:.2f} ms "
             f"({t / busy:.3f} of busy)")
    for key, (n, t) in sorted(names.items(), key=lambda x: -x[1][1])[:12]:
        _log(f"profile kernel {n:6d} x {t / n:8.2f} us = {t / 1e3:8.2f} ms "
             f"{key[:110]}")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    if argv == ["--profile"]:
        phase_profile()
        _log(f"total {time.perf_counter() - t0:.1f}s on {card}")
        return 0
    if argv:
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    rows = [phase_flash(), phase_paged()]
    launches, _ = phase_slice()
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    _log(f"total {time.perf_counter() - t0:.1f}s on {card}")
    _log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
