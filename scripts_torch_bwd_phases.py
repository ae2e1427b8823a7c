#!/usr/bin/env python3
"""Where the NodeEncoder backward kernel's time goes, on one CUDA card.

    python3 scripts_torch_bwd_phases.py [--warps 1,4,16] [--out PATH]

Builds, beside the checkout's `csrc/decima_encoder_bwd.cu`, copies of it
that differ only in warps per block (`MAX_WARPS`) and one that adds
clock64 counters around each pass it calls (`rows_fwd`, `level_fwd`,
`level_bwd`, `rows_bwd`, the restore of saved pre-activations) and the
code between them; a few warps print their counts per job. Each version
runs on the same seeded chunk (`make_case("dag", 256, 44, ...)`, ~11k
live jobs, the flagship widths, num_levels 5), is checked against the
checkout's version and timed with CUDA events. Prints one JSON line per
version, the counters and the card's name and power limit; writes them
to --out. The copies are written to a temporary directory, never to the
checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
import tempfile

import chip_smoke
import scripts_torch_encoder_ab as ab

PASSES = {"rows_fwd": 1, "level_fwd": 2, "level_bwd": 3, "rows_bwd": 4,
          "restore": 5}
NAMES = ("other", "rows_fwd", "level_fwd", "level_bwd", "rows_bwd",
         "restore", "between")


def with_counters(src: str) -> str:
    """The kernel source with clock64 counters around every pass call in
    the job loop, printed by warps 0 and the last of blocks 0 and 1."""
    a = src.index("  const int mo_msg = d.upd.rlen;\n")
    b = src.index("// partial[g][e] = the sum over the warps")
    body, out, pos = src[a:b], "", 0
    for m in re.finditer(r"^( *)(%s)\(" % "|".join(PASSES), body, re.M):
        if m.start() < pos:
            continue
        end = body.index(";", m.end()) + 1
        out += (body[pos:m.start()] + f"{m.group(1)}{{ TICK(6); "
                + body[m.start():end].lstrip()
                + f" TICK({PASSES[m.group(2)]}); }}")
        pos = end
    body = (out + body[pos:]).replace(
        "  const int mo_msg = d.upd.rlen;\n",
        "  const int mo_msg = d.upd.rlen;\n"
        "  long long ph[7] = {0};\n  long long tk = clock64();\n"
        "  int njobs = 1;\n"
        "  auto TICK = [&](int i) { const long long t2 = clock64();"
        " ph[i] += t2 - tk; tk = t2; };\n", 1)
    tail = "    par ^= 1;\n  }\n  cp_wait<0>();\n}"
    assert tail in body
    body = body.replace(tail, (
        "    par ^= 1;\n    ++njobs;\n  }\n  cp_wait<0>();\n  TICK(0);\n"
        "  if (lane == 0 && blockIdx.x < 2 && (wid == 0 || wid == d0.wpb - 1))"
        "\n    printf(\"PHASES %d %lld %lld %lld %lld %lld %lld %lld\\n\","
        " njobs, ph[0], ph[1], ph[2], ph[3], ph[4], ph[5], ph[6]);\n}"))
    return ("#include <cstdio>\n" + src[:a] + body + src[b:])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warps", default="1,4,16")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="test_artifacts/bwd_phases.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from sparksched_tpu_torch.kernels import build
    from sparksched_tpu_torch.kernels.decima_encoder import pack_weights

    src = open(os.path.join(build.CSRC, "decima_encoder_bwd.cu")).read()
    assert "#define MAX_WARPS 16 " in src
    tmp = tempfile.mkdtemp()
    sources = {}
    for w in a.warps.split(","):
        path = os.path.join(tmp, f"w{w}.cu")
        with open(path, "w") as fh:
            fh.write(src.replace("#define MAX_WARPS 16 ",
                                 f"#define MAX_WARPS {int(w)} "))
        sources[f"warps_{w}"] = path
    path = os.path.join(tmp, "counters.cu")
    with open(path, "w") as fh:
        fh.write(with_counters(src))
    sources["counters"] = path
    libs, ptxas = ab.build_all(sources, tmp)
    x, adj, lvl, mask = chip_smoke.parity_helpers().make_case(
        "dag", 256, 44, 20, 5, seed=3)

    class Features:
        pass

    f = Features()
    f.x, f.adj, f.node_level, f.node_mask = (
        torch.from_numpy(t).cuda() for t in (x, adj, lvl, mask))
    gen = torch.Generator().manual_seed(7)

    def layers(dims):
        return [(torch.randn(o, i, generator=gen).cuda() * i ** -0.5,
                 torch.randn(o, generator=gen).cuda() * 0.1)
                for i, o in zip(dims[:-1], dims[1:])]

    w = pack_weights(layers([5, 32, 16, 16]), layers([16, 32, 16, 16]),
                     layers([16, 32, 16, 16]))
    g = torch.randn(256, 44, 20, 16, device="cuda")
    calls = {n: ab.bwd_launcher(lib, f, w, g, 5, 0.2, False)[0]
             for n, lib in libs.items()}
    ref = [t.clone() for t in calls["warps_16"]()]
    results = {"card": chip_smoke.card_line(),
               "live_jobs": int(mask.any(-1).sum()), "versions": {}}
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        agree = max(float((x - y).abs().max() / (y.abs().max() + 1e-12))
                    for x, y in zip(got, ref))
        results["versions"][name] = {
            "event_ms": chip_smoke.cuda_ms(call, a.reps),
            "max_rel_diff_vs_16_warps": agree,
            "ptxas": [ln for ln in ptxas[name]
                      if "registers" in ln or "spill" in ln]}
        print(json.dumps({"version": name, **results["versions"][name]}),
              flush=True)
    # the counters' lines, from one more launch with stdout captured
    r, wfd = os.pipe()
    saved = os.dup(1)
    os.dup2(wfd, 1)
    try:
        calls["counters"]()
        torch.cuda.synchronize()
        ctypes.CDLL(None).fflush(None)  # the device printf, through stdio
    finally:
        os.dup2(saved, 1)
        os.close(wfd)
    text = os.read(r, 1 << 20).decode()
    os.close(r)
    rows = []
    for ln in text.splitlines():
        if ln.startswith("PHASES"):
            v = [int(t) for t in ln.split()[1:]]
            rows.append({"jobs": v[0]} | {
                f"{n}_cycles_per_job": v[1 + i] / v[0]
                for i, n in enumerate(NAMES)})
    results["counters"] = rows
    print(json.dumps({"counters": rows}))
    print(results["card"])
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
