"""Device memory of the multi-tenant service at gemma3-4b's full width:
two tenants fine-tuned by B-KFAC (``serve/load.py``'s cadence) and served,
as ``chip_smoke.py``'s ``slice_serve`` runs them.

    PYTHONPATH=src python -m repro_torch.tools.serve_memory [--layers 1,1]

``--layers`` gives the repeats of gemma3-4b's two segments (1,1: 10 of
its 34 layers, 1,0: 6).  Prints one JSON line for each stage — the
stacked weights, the bank's state, then two fine-tune ticks of both
tenants (the first statistics step and a light one) with a decode step
each — with the memory held after it and the peak while it ran (an
out-of-memory failure is printed with the peak it reached, then the run
stops), one line for each span inside a tick (each tenant's backward,
each factor and precondition bucket, the decode step) with the memory
held before it, its peak and the allocator's reserved bytes, and the
card's name and power limit.  ``--expandable`` switches the caching
allocator to expandable segments first.  It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.launch.param_count import count_params
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Request
from repro_torch.serve.load import finetune_kfac_config
from repro_torch.serve.service import FinetuneRequest, TenantService

GB = 1e9


def _span(name, fn):
    """``fn`` with one JSON line a call: memory held before, the peak
    during it, and the allocator's reserved bytes after."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        print(json.dumps({"span": name(*a) if callable(name) else name,
                          "held_before_gb": before / GB,
                          "peak_gb": torch.cuda.max_memory_allocated() / GB,
                          "reserved_gb": torch.cuda.memory_reserved() / GB}),
              flush=True)
        return out
    return run


def trace_spans(svc):
    """Memory lines around a tick's spans (see the module docstring)."""
    from repro_torch.core import kfactor
    from repro_torch.serve import service as service_lib
    from repro_torch.train import loop
    service_lib.loop_lib = type("L", (), {"kfac_grads": staticmethod(
        _span("backward", loop.kfac_grads))})
    kfactor_step = kfactor.bucket_factor_step_async
    kfac_lib.kfactor.bucket_factor_step_async = _span(
        lambda spec, st, X, *a: f"factor d={spec.d} B={X.shape[0]}",
        kfactor_step)
    opt = svc.opt
    opt._precondition_bucket = _span(
        lambda b, *a: f"precond d_in={b.spec_a.d} d_out={b.spec_g.d} "
                      f"B={b.total}", opt._precondition_bucket)
    svc.engine.step = _span("decode", svc.engine.step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="1,1")
    ap.add_argument("--expandable", action="store_true")
    args = ap.parse_args(argv)
    if args.expandable:
        set_allocator = getattr(
            torch._C, "_accelerator_setAllocatorSettings",
            None) or torch.cuda.memory._set_allocator_settings
        set_allocator("expandable_segments:True")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("gemma3_4b").with_repeats(
        tuple(int(r) for r in args.layers.split(",")))
    n = 2
    held = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        err = None
        try:
            out = fn()
            torch.cuda.synchronize()
        except torch.OutOfMemoryError as e:
            err, out = str(e).splitlines()[0], None
        line = {"stage": name, "n_layers": arch.n_layers, "tenants": n,
                "held_gb": torch.cuda.memory_allocated() / GB,
                "peak_gb": torch.cuda.max_memory_allocated() / GB,
                "wall_s": time.perf_counter() - t0, "oom": err}
        print(json.dumps(line | held), flush=True)
        if err is not None:
            raise SystemExit(1)
        return out

    lm = LM(arch, remat=False, device=dev)
    opt = kfac_lib.Kfac(finetune_kfac_config(arch), lm.taps, device=dev)

    def build():
        base = lm.init(torch.Generator(device=dev).manual_seed(0))
        svc = TenantService(lm, opt, base, n, max_len=48)
        return svc
    svc = stage("build", build)
    trace_spans(svc)
    torch.cuda.empty_cache()
    st = svc.state
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    held.update({
        "params": count_params(arch),
        "params_gb": nbytes(svc.params.values()) / GB,
        "fallback_gb": nbytes(list(st.fallback.mu.values())
                              + list(st.fallback.nu.values())) / GB,
        "factors_gb": nbytes([x for f in st.factors.values()
                              for s in (f.A, f.G)
                              for x in (s.U, s.D, s.M, s.aux)]) / GB})
    del st
    rng = np.random.default_rng(0)
    B, T = svc.ft_shape
    for k in range(2):
        def tick():
            for t in range(n):
                batch = {key: rng.integers(0, arch.vocab, (B, T))
                         for key in ("tokens", "targets")}
                svc.submit(FinetuneRequest(uid=10 * k + t, tenant=t,
                                           batch=batch))
                svc.submit(Request(uid=100 + 10 * k + t, prompt=[1, 2],
                                   max_new=1, tenant=t))
            svc.tick()
        stage(f"tick{k}", tick)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
