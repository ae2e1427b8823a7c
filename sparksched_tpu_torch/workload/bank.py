"""Workload template bank: DAG-job traces packed into device tensors
(counterpart of `sparksched_tpu/workload/bank.py`).

Every job template is packed once into fixed-shape tensors shared by all
sessions: structure (`adj[T,S,S]`, `num_tasks[T,S]`, `num_stages[T]`,
topological `node_level[T,S]`) and durations (`dur[T,S,3,L,K]` buckets
of K samples per (stage, wave, executor level), counts `cnt[T,S,3,L]`
and presence masks). Sampling a duration is then a few gathers from
these tensors. The packing itself is host numpy, identical to the JAX
package's, so both banks hold the same numbers. `quantize_bank` narrows
the duration table (`bank_dtype`: int16 / int8 in the log domain with a
per-template scale, bf16 as a cast), with the JAX package's host
arithmetic, so the narrow tables are equal too.
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Any

import numpy as np
import torch

# executor-count levels at which the TPC-H traces record durations
# (reference tpch.py:238)
EXEC_LEVEL_VALUES = (5, 10, 20, 40, 50, 60, 80, 100)
NUM_EXEC_LEVELS = len(EXEC_LEVEL_VALUES)

# wave indices into the duration buckets
WAVE_FRESH, WAVE_FIRST, WAVE_REST = 0, 1, 2

NUM_QUERIES = 22
QUERY_SIZES = ("2g", "5g", "10g", "20g", "50g", "80g", "100g")


@dataclasses.dataclass(frozen=True)
class WorkloadBank:
    """Packed template bank on one device. T templates, S stage slots,
    L executor levels, K duration samples per bucket, N executors."""

    num_stages: torch.Tensor  # i32[T]
    num_tasks: torch.Tensor  # i32[T,S]
    adj: torch.Tensor  # bool[T,S,S]; adj[t,p,c] iff edge p->c
    node_level: torch.Tensor  # i32[T,S]; topological generation, S = pad
    rough_duration: torch.Tensor  # f32[T,S]
    dur: torch.Tensor  # f32[T,S,3,L,K]
    cnt: torch.Tensor  # i32[T,S,3,L]
    level_present: torch.Tensor  # bool[T,S,L]
    max_present: torch.Tensor  # i32[T,S]
    itv_left_val: torch.Tensor  # i32[N+1]
    itv_right_val: torch.Tensor  # i32[N+1]
    itv_left_idx: torch.Tensor  # i32[N+1]
    itv_right_idx: torch.Tensor  # i32[N+1]
    # int-coded banks only (`quantize_bank`): the per-template f32[T]
    # log-domain scale, duration = expm1(dur * dur_scale[t]), applied at
    # the one gather site (`sampling.sample_task_duration`); None for the
    # f32 and bf16 tables
    dur_scale: torch.Tensor | None = None

    @property
    def num_templates(self) -> int:
        return self.num_stages.shape[0]

    @property
    def max_stages(self) -> int:
        return self.num_tasks.shape[1]

    @property
    def bucket_size(self) -> int:
        return self.dur.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.dur.device


def topological_levels(adj: np.ndarray, num_stages: int) -> np.ndarray:
    """Kahn's algorithm returning the topological generation index of each
    node (same grouping as nx.topological_generations). Padding slots get
    level == S."""
    s_cap = adj.shape[0]
    level = np.full(s_cap, s_cap, dtype=np.int32)
    indeg = adj[:num_stages, :num_stages].sum(axis=0)
    frontier = [int(i) for i in np.flatnonzero(indeg == 0)]
    cur = 0
    while frontier:
        nxt = []
        for u in frontier:
            level[u] = cur
            for v in np.flatnonzero(adj[u, :num_stages]):
                indeg[v] -= 1
                if indeg[v] == 0:
                    nxt.append(int(v))
        frontier = nxt
        cur += 1
    assert (level[:num_stages] < s_cap).all(), "adjacency has a cycle"
    return level


def _executor_intervals(num_executors: int) -> np.ndarray:
    """Map num_local_executors -> (left, right) executor-level VALUES,
    reproducing the reference table exactly (tpch.py:237-262), including its
    behavior of leaving index `num_executors` zeroed when
    num_executors > max level (the presence fallback then kicks in)."""
    levels = list(EXEC_LEVEL_VALUES)
    cap = num_executors
    intervals = np.zeros((cap + 1, 2), dtype=np.int64)
    intervals[: levels[0] + 1] = levels[0]
    for i in range(len(levels) - 1):
        intervals[levels[i] + 1 : levels[i + 1]] = (levels[i], levels[i + 1])
        if levels[i + 1] > cap:
            break
        intervals[levels[i + 1]] = levels[i + 1]
    if cap > levels[-1]:
        intervals[levels[-1] + 1 : cap] = levels[-1]
    return intervals


def _value_to_index() -> dict[int, int]:
    return {v: i for i, v in enumerate(EXEC_LEVEL_VALUES)}


def pack_bank(
    templates: list[dict[str, Any]],
    num_executors: int,
    max_stages: int,
    bucket_size: int,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> WorkloadBank:
    """Pack host-side template dicts (see the JAX package's `pack_bank`
    for the format) into a WorkloadBank on `device`."""
    rng = np.random.default_rng(seed)
    t_n = len(templates)
    s_cap = max_stages
    l_n = NUM_EXEC_LEVELS
    k = bucket_size

    num_stages = np.zeros(t_n, dtype=np.int32)
    num_tasks = np.zeros((t_n, s_cap), dtype=np.int32)
    adj = np.zeros((t_n, s_cap, s_cap), dtype=bool)
    node_level = np.full((t_n, s_cap), s_cap, dtype=np.int32)
    rough = np.zeros((t_n, s_cap), dtype=np.float32)
    dur = np.zeros((t_n, s_cap, 3, l_n, k), dtype=np.float32)
    cnt = np.zeros((t_n, s_cap, 3, l_n), dtype=np.int32)
    present = np.zeros((t_n, s_cap, l_n), dtype=bool)
    max_present = np.zeros((t_n, s_cap), dtype=np.int32)

    v2i = _value_to_index()
    wave_names = {"fresh_durations": WAVE_FRESH, "first_wave": WAVE_FIRST,
                  "rest_wave": WAVE_REST}

    for t, tpl in enumerate(templates):
        s_n = tpl["adj"].shape[0]
        assert s_n <= s_cap, f"template {t} has {s_n} stages > cap {s_cap}"
        num_stages[t] = s_n
        num_tasks[t, :s_n] = tpl["num_tasks"]
        adj[t, :s_n, :s_n] = tpl["adj"]
        node_level[t] = topological_levels(adj[t], s_n)

        for s in range(s_n):
            stage_data = tpl["durations"][s]
            all_durs: list[float] = []
            for wname, w in wave_names.items():
                for lv, samples in stage_data.get(wname, {}).items():
                    li = v2i[int(lv)]
                    samples = np.asarray(samples, dtype=np.float32)
                    all_durs.extend(samples.tolist())
                    if samples.size == 0:
                        continue
                    if samples.size > k:
                        samples = rng.choice(samples, size=k, replace=False)
                    n = samples.size
                    dur[t, s, w, li, :n] = samples
                    cnt[t, s, w, li] = n
            for lv in stage_data.get("first_wave", {}):
                present[t, s, v2i[int(lv)]] = True
            pres_idx = np.flatnonzero(present[t, s])
            max_present[t, s] = pres_idx.max() if pres_idx.size else 0
            rough[t, s] = float(np.mean(all_durs)) if all_durs else 1.0

    itv = _executor_intervals(num_executors)
    lv_arr = np.array(EXEC_LEVEL_VALUES, dtype=np.int64)

    def to_idx(vals: np.ndarray) -> np.ndarray:
        # map values to level indices; unknown values (e.g. the zeroed tail
        # entry of the reference table) map to index 0 — the presence
        # fallback replaces them anyway
        idx = np.zeros_like(vals)
        for i, v in enumerate(lv_arr):
            idx[vals == v] = i
        return idx

    def t(a, dtype=None):
        a = np.asarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return WorkloadBank(
        num_stages=t(num_stages),
        num_tasks=t(num_tasks),
        adj=t(adj),
        node_level=t(node_level),
        rough_duration=t(rough),
        dur=t(dur),
        cnt=t(cnt),
        level_present=t(present),
        max_present=t(max_present),
        itv_left_val=t(itv[:, 0], np.int32),
        itv_right_val=t(itv[:, 1], np.int32),
        itv_left_idx=t(to_idx(itv[:, 0]), np.int32),
        itv_right_idx=t(to_idx(itv[:, 1]), np.int32),
    )


BANK_DTYPES = ("f32", "float32", "bf16", "bfloat16", "int8", "int16")


def bank_dtype_label(bank: WorkloadBank) -> str:
    """Short dtype tag of a bank's `dur` table ("f32", "bf16", "int8",
    "int16"), the JAX package's labels."""
    return {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8", torch.int16: "int16"}[bank.dur.dtype]


def quantize_bank(bank: WorkloadBank, dtype: str = "int16") -> WorkloadBank:
    """The bank with its `dur[T,S,3,L,K]` table in a narrow dtype (the JAX
    package's `quantize_bank`).

    int8/int16: log-domain codes with a per-template f32 scale, `q =
    rint(log1p(dur) / dur_scale[t])`, `dur_scale[t] = log1p(max(dur[t]))
    / intmax`, so the error is relative (at most expm1(dur_scale[t] / 2))
    across the heavy tail of TPC-H durations. The codes are computed in
    float64 on the host, as the JAX package does: an f32 log could land a
    value across a half-step boundary. bfloat16: a plain cast. The table
    is dequantized to f32 at its one gather site
    (`sampling.sample_task_duration`); `rough_duration` stays f32."""
    if dtype in ("f32", "float32"):
        return bank
    if dtype in ("bf16", "bfloat16"):
        return dataclasses.replace(bank, dur=bank.dur.to(torch.bfloat16),
                                   dur_scale=None)
    if dtype not in ("int8", "int16"):
        raise ValueError(f"unknown bank dtype {dtype!r} (have: "
                         f"{BANK_DTYPES})")
    imax = 127 if dtype == "int8" else 32767
    ldur = np.log1p(bank.dur.cpu().numpy().astype(np.float64))
    t_max = ldur.reshape(ldur.shape[0], -1).max(axis=1)
    scale = np.where(t_max > 0, t_max / imax, 1.0)
    q = np.rint(ldur / scale[:, None, None, None, None])
    q = np.clip(q, 0, imax).astype(dtype)
    dev = bank.dur.device
    return dataclasses.replace(
        bank, dur=torch.from_numpy(q).to(dev),
        dur_scale=torch.from_numpy(scale.astype(np.float32)).to(dev))


def load_tpch_templates(data_dir: str = "data/tpch") -> list[dict[str, Any]]:
    """Load the real TPC-H traces (if present on disk) into host template
    dicts, applying the same preprocessing as the reference: fresh durations
    are removed from first_wave, and empty first-wave lists borrow the
    nearest lower executor level's (tpch.py:135-162)."""
    templates = []
    for size in QUERY_SIZES:
        for q in range(1, NUM_QUERIES + 1):
            qdir = osp.join(data_dir, size)
            adj = np.load(osp.join(qdir, f"adj_mat_{q}.npy"), allow_pickle=True)
            tdd = np.load(
                osp.join(qdir, f"task_duration_{q}.npy"), allow_pickle=True
            ).item()
            s_n = adj.shape[0]
            durations = {}
            ntasks = np.zeros(s_n, dtype=np.int64)
            for s in range(s_n):
                data = {k: {lv: list(v) for lv, v in d.items()}
                        for k, d in tdd[s].items()}
                e0 = next(iter(data["first_wave"]))
                ntasks[s] = len(data["first_wave"][e0]) + len(
                    data["rest_wave"][e0]
                )
                _preprocess_first_wave(data)
                durations[s] = data
            templates.append(
                {"adj": adj.astype(bool), "num_tasks": ntasks,
                 "durations": durations, "query_num": q, "query_size": size}
            )
    return templates


def _preprocess_first_wave(data: dict[str, Any]) -> None:
    """Remove fresh durations from first_wave lists, then fill empty lists
    from the nearest lower level (reference tpch.py:135-162)."""
    clean: dict[int, list[float]] = {}
    for e in data["first_wave"]:
        clean[e] = []
        fresh: dict[float, int] = {}
        for d in data["fresh_durations"].get(e, []):
            fresh[d] = fresh.get(d, 0) + 1
        for d in data["first_wave"][e]:
            if fresh.get(d, 0) > 0:
                fresh[d] -= 1
            else:
                clean[e].append(d)
    last: list[float] = []
    for e in sorted(clean.keys()):
        if len(clean[e]) == 0:
            clean[e] = last
        last = clean[e]
    data["first_wave"] = clean
