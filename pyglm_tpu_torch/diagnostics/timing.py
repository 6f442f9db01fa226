"""What the timing scripts of this folder and ``chip_smoke.py`` share: a
copy of the package with parts of one kernel source cut out, a digest of
tensors, the kernels' device time by torch.profiler, and K3's priors.

The scripts import it from their own folder (``from timing import ...``),
so that the package they time may come from another checkout."""
from __future__ import annotations

import hashlib
import shutil
from pathlib import Path


def cut_copy(root: Path, name: str, source: str,
             cuts: dict[str, tuple[str, str]], parts: list[str]) -> Path:
    """A copy of ROOT's package under ROOT/build/<name>_<parts>/ in which
    each of `parts` replaces a statement of csrc/<source>: cuts[part] =
    (old, new). Exits if a part does not apply to that source. Returns the
    copy's root, to be put first on sys.path."""
    dst = root / "build" / f"{name}_{'_'.join(parts)}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "pyglm_tpu_torch", dst / "pyglm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "pyglm_tpu_torch" / "csrc" / source
    src = path.read_text()
    for part in parts:
        old, new = cuts.get(part, ("", ""))
        if not old or old not in src:
            raise SystemExit(f"--cut {part} does not apply to {path}")
        src = src.replace(old, new)
    path.write_text(src)
    return dst


def digest(*ts) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes: equal
    digests, the same values bit for bit."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_ms(fn, reps) -> dict[str, float]:
    """{kernel name: device ms per call of `fn`} over `reps` calls traced
    by torch.profiler, after one untraced call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type.name == "CUDA":
            out[ev.key] = out.get(ev.key, 0.0) + us / 1e3 / reps
    return out


def edge_scan_priors(gen, n_edges, lanes, B, device="cuda"):
    """K3's priors and noise for `n_edges` edges x `lanes` lanes: a
    non-identity Lam0 (M M^T / B + I), mu0 ~ 0.3 N(0, 1), logit rho = -1,
    u_a ~ U(0, 1) and eps ~ N(0, 1). (mu, lam, lrho, u_a, eps)."""
    import torch
    M = torch.randn((n_edges, lanes, B, B), generator=gen, device=device)
    lam = (M @ M.transpose(-1, -2) / B
           + torch.eye(B, device=device)).contiguous()
    del M
    mu = 0.3 * torch.randn((n_edges, lanes, B), generator=gen, device=device)
    lrho = torch.full((n_edges, lanes), -1.0, device=device)
    u_a = torch.rand((n_edges, lanes), generator=gen, device=device)
    eps = torch.randn((n_edges, lanes, B), generator=gen, device=device)
    return mu, lam, lrho, u_a, eps
