"""Kernel-vs-plain-version comparison cases — one corpus, its consumers.

Each :class:`KernelCase` pairs a kernel invocation through ``ops`` with its
``ref.py`` (or numpy Adam) plain version on seeded inputs shaped like the
training hot path (GQA head ratio, SSD group broadcast, non-default eps):
the cases, labels and shapes of ``repro.kernels.check`` (the JAX package).
``ops.TOLERANCE_TIERS`` declares the acceptance bound per kernel.

Inputs come from numpy ``default_rng`` generators seeded from ``seed``
(``jax.random`` gives other numbers; the Adam case draws exactly the
reference's inputs) and are placed on ``device``, the card by default.  On the
card ``run_kernel`` launches the hand-written kernels; on the CPU it runs
the plain versions, so the rows there compare the plain versions with
themselves and with the numpy Adam.

On the card these shapes send work to two routes that no full-width main
path runs: float32 flash attention at head_dim 32 goes to the 3xTF32
tensor-core kernel (``csrc/flash_attention_tf32.cu``), and the SSD scan at
chunk 8 to the CUDA-core kernel (``csrc/ssd_scan.cu``).

Consumers:
* ``core.invariants.KernelConsistencyChecker`` — spot-checks every kernel on
  the card at cluster start before lockstepping the card/CPU twins;
* ``chip_smoke.py`` — the corpus on the card;
* ``tests/test_torch_kernel_check.py`` — the corpus against the reference's
  plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import ops, ref


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One comparison: ``run_kernel()`` / ``run_ref()`` -> list of f32 arrays
    (same order), judged under ``ops.TOLERANCE_TIERS[name]``.  ``inputs``
    holds the case's tensors and scalars, on the case's device; it is not in
    the reference's ``KernelCase`` and exists for the cross-package test,
    which feeds these very inputs to the reference's plain versions."""
    name: str               # TOLERANCE_TIERS key
    label: str              # unique case id (a kernel can have many cases)
    run_kernel: Callable[[], List[np.ndarray]]
    run_ref: Callable[[], List[np.ndarray]]
    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def tier(self) -> Dict[str, float]:
        return ops.TOLERANCE_TIERS[self.name]


def _np(outs) -> List[np.ndarray]:
    return [o.detach().float().cpu().numpy() for o in outs]


def kernel_cases(seed: int = 0, device=None) -> List[KernelCase]:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_cases: no CUDA device is visible; pass "
                           "device='cpu' for the plain versions")
    rng = np.random.default_rng([seed, 1])

    def normal(*shape) -> torch.Tensor:
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    cases: List[KernelCase] = []

    # -- flash attention, GQA head ratio, causal + non-causal ---------------
    B, S, H, Hkv, hd = 2, 64, 8, 2, 32
    q, kk, v = normal(B, S, H, hd), normal(B, S, Hkv, hd), normal(B, S, Hkv, hd)

    def flash_ref(causal):
        rep = H // Hkv
        kf = kk.repeat_interleave(rep, dim=2).transpose(1, 2) \
            .reshape(B * H, S, hd)
        vf = v.repeat_interleave(rep, dim=2).transpose(1, 2) \
            .reshape(B * H, S, hd)
        qf = q.transpose(1, 2).reshape(B * H, S, hd)
        o = ref.mha_reference(qf, kf, vf, causal=causal)
        return _np([o.reshape(B, H, S, hd).transpose(1, 2)])

    for causal in (True, False):
        cases.append(KernelCase(
            "flash_attention",
            f"flash_attention[gqa,{'causal' if causal else 'bidir'}]",
            run_kernel=(lambda c=causal: _np(
                [ops.flash_attention(q, kk, v, causal=c)])),
            run_ref=(lambda c=causal: flash_ref(c)),
            inputs=dict(q=q, k=kk, v=v, causal=causal)))

    # -- rmsnorm, non-default eps -------------------------------------------
    x = normal(4, 16, 64)
    scale = 1.0 + 0.1 * normal(64)
    eps = 1e-3
    cases.append(KernelCase(
        "rmsnorm", "rmsnorm[eps=1e-3]",
        run_kernel=lambda: _np([ops.rmsnorm(x, scale, eps=eps)]),
        run_ref=lambda: _np([ref.rmsnorm_reference(x, scale, eps=eps)]),
        inputs=dict(x=x, scale=scale, eps=eps)))

    # -- ssd scan, group broadcast ------------------------------------------
    b, s, h, p, g, n = 2, 32, 4, 16, 2, 16
    sx = normal(b, s, h, p)
    dt = F.softplus(normal(b, s, h))
    A = -torch.exp(normal(h))
    Bm, Cm = normal(b, s, g, n), normal(b, s, g, n)
    chunk = 8

    def ssd_ref():
        rep = h // g
        y, _ = ref.ssd_reference(sx, dt, A, Bm.repeat_interleave(rep, dim=2),
                                 Cm.repeat_interleave(rep, dim=2))
        return _np([y])

    cases.append(KernelCase(
        "ssd_scan", "ssd_scan[groups]",
        run_kernel=lambda: _np(
            [ops.ssd_scan(sx, dt, A, Bm, Cm, chunk=chunk)[0]]),
        run_ref=ssd_ref,
        inputs=dict(x=sx, dt=dt, A=A, B=Bm, C=Cm, chunk=chunk)))

    # -- fused adam vs the host-numpy hot-path oracle -----------------------
    from repro_torch.optim.adam import AdamConfig, adam_update_flat_np
    acfg = AdamConfig()
    nvec = 4097                       # n % 4 != 0: the kernel's scalar tail
    arng = np.random.default_rng(seed)
    gvec = arng.standard_normal(nvec).astype(np.float32)
    st = {"master": arng.standard_normal(nvec).astype(np.float32),
          "mu": (arng.standard_normal(nvec) * 0.01).astype(np.float32),
          "nu": np.abs(arng.standard_normal(nvec) * 0.01).astype(np.float32)}
    step = 7

    def adam_kernel():
        m, mu, nu = (torch.from_numpy(st[c].copy()).to(dev)
                     for c in ("master", "mu", "nu"))
        ops.fused_adam_(torch.from_numpy(gvec).to(dev), m, mu, nu, step=step,
                        b1=acfg.b1, b2=acfg.b2, eps=acfg.eps, lr=acfg.lr,
                        weight_decay=acfg.weight_decay)
        return _np([m, mu, nu])

    def adam_ref():
        out = adam_update_flat_np(gvec, st, step, acfg)
        return [np.asarray(out[c], np.float32) for c in ("master", "mu", "nu")]

    cases.append(KernelCase("fused_adam", "fused_adam[n=4097]",
                            run_kernel=adam_kernel, run_ref=adam_ref,
                            inputs=dict(grad=gvec, step=step, **st)))
    return cases


def case_row(case: KernelCase) -> Dict:
    """Run one case; returns the comparison row (no timing)."""
    got, want = case.run_kernel(), case.run_ref()
    tier = case.tier
    max_err = max((float(np.max(np.abs(g - w))) if g.size else 0.0)
                  for g, w in zip(got, want))
    within = all(np.allclose(g, w, rtol=tier["rtol"], atol=tier["atol"])
                 for g, w in zip(got, want))
    return {"kernel": case.name, "case": case.label,
            "max_abs_err": max_err, "rtol": tier["rtol"],
            "atol": tier["atol"], "within_tolerance": bool(within)}


def check_kernels(seed: int = 0, device=None) -> List[Dict]:
    """All comparison rows for one seed on ``device`` (the card by default;
    raise-free: callers gate)."""
    return [case_row(c) for c in kernel_cases(seed, device)]
