"""Reading a torch.profiler trace of a span of whole steps.

``Trace`` holds the span's device operations (kernels, copies and sets:
every CUDA record but user annotations, whose device ranges span kernels
counted on their own) and the host's operations, on one clock in
nanoseconds. From them: the span (first device operation's start to the
last one's end), the time in which some device operation ran (the union
of their intervals), device time by kernel group, the longest idle gaps
with what the host was doing meanwhile, and the operations that took most
time. The kernel groups are ``chip_smoke.py``'s ``KERNEL_GROUPS``, copied.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# (group, substrings of its kernels' names), first match wins
KERNEL_GROUPS = (
    ("K1 attention fwd", ("attn_fwd_kernel",)),
    ("K2 attention bwd", ("attn_bwd_",)),
    ("K5 attention_hm fwd", ("attn_hm_fwd_kernel", "attn_hm_wide_fwd")),
    ("K6 attention_hm bwd", ("attn_hm_bwd_", "attn_hm_wide_dq",
                             "attn_hm_wide_dkdv")),
    ("K10 ln bwd", ("ln_bwd_rows_kernel", "ln_bwd_cols_kernel")),
    ("K3 LN rows", ("ln_mlp_rows_kernel",)),
    ("K3/K4 fc1 pass", ("mlp_fc1_kernel",)),
    ("K3/K4 fc2 pass", ("mlp_fc2_kernel",)),
    ("K7/K8 gh pass", ("mlp_gh_kernel", "colsum_fold")),
    ("K7/K8 dx pass", ("mlp_dx_kernel",)),
    ("K9 mlp dw", ("mlp_dw_",)),
    ("K3/K4/K7/K8 partial-sum epilogue", ("mlp_epilogue",)),
    ("NCCL collectives", ("nccl",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("Adam", ("multi_tensor_apply", "adam")),
)
OTHER = "other (elementwise, reductions, copies)"
ATTENTION = ("K1 attention fwd", "K2 attention bwd", "K5 attention_hm fwd",
             "K6 attention_hm bwd")
LN_MLP = ("K10 ln bwd", "K3 LN rows", "K3/K4 fc1 pass", "K3/K4 fc2 pass",
          "K7/K8 gh pass", "K7/K8 dx pass", "K9 mlp dw",
          "K3/K4/K7/K8 partial-sum epilogue")


def group_of(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


class Trace:
    """The device and host operations of one profiled span."""

    def __init__(self, prof):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.device: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    self.device.append((e.name(), start, end))
            else:
                self.host.append((e.name(), start, end))
        self.device.sort(key=lambda r: r[1])

    # ------------------------------------------------------------ timeline
    def span_s(self) -> float:
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device) - self.device[0][1]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The ``top`` longest gaps between device operations, each named by
        the innermost host operation that was running when it began."""
        busy = self.busy_intervals()
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                       for i in range(len(busy) - 1)), reverse=True)[:top]
        out = []
        for length, at in gaps:
            inner = [(e - s, n) for n, s, e in self.host if s <= at < e]
            out.append([min(inner)[1] if inner else "host idle", length / 1e9])
        return out

    # ------------------------------------------------------------- groups
    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            g = group_of(name)
            out[g] = out.get(g, 0.0) + (e - s) / 1e9
        return out

    def family_s(self, groups) -> float:
        g = self.group_s()
        return sum(g.get(k, 0.0) for k in groups)

    def top_ops(self, top: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for name, s, e in self.device:
            per[name] = per.get(name, 0.0) + (e - s) / 1e9
        return [[n[:200], t] for n, t in
                sorted(per.items(), key=lambda kv: -kv[1])[:top]]
