#!/usr/bin/env python3
"""The LM kernels at the serving shapes, timed in two trees in turns.

    python3 scripts/kernel_ab.py --parent DIR [--out PATH]

``DIR`` is another checkout of the repository (say, the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each tree's
``flash_attention`` and ``chunk_scan`` are built into its own
``build/repro_torch_kernels/`` and timed in a process of their own, in
the order parent, this tree, this tree, parent, ``ROUNDS`` times over,
all on one card in one call, so that a difference between the
trees is not one between cards or hosts.  Shapes: ``chip_smoke.py``'s phase 10 and 14 serving shapes
(qwen3-4b's prefill causal and under window 512, hubert-xlarge's,
zamba2-2.7b's shared attention, the LM evaluator's f32 attention;
rwkv6-7b's scan and zamba2's Mamba2 scan in the model's call form) and
its bf16 mma.sync tiles at head dims 96 and 256, mamba2-2.7b's
128-channel scan and the scan at K 256 in both modes, off the serving
paths, each by ``chip_smoke.time_device`` (the profiler's device time over
200 calls, inputs cycled past the L2).  Prints one JSON line a run, then
each shape's change-over-parent ratio of every round (the mean of its two
change runs over the mean of its two parent runs) and of all rounds, and
writes the runs and ratios, with the card's name and power limit, to
``--out``.  Needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 3     # each round's ratio beside the others shows the card's spread


def time_tree(tree: Path) -> dict:
    """This process: the kernels of ``tree`` at the serving shapes (ms)."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs        # its timing helpers need torch alone
    from repro_torch import kernels
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.flash_attention import flash_attention
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not {tree}'s")
    kernels.build_all(("flash_attention", "chunk_scan"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    out = {}
    for key, (B, S, H, KV, hd), causal, window, dt in (
            ("prefill", (4, 2048, 32, 8, 128), True, 0, torch.bfloat16),
            ("prefill_w512", (4, 2048, 32, 8, 128), True, 512,
             torch.bfloat16),
            ("hubert", (4, 2048, 16, 16, 80), False, 0, torch.bfloat16),
            ("zamba2", (4, 2048, 32, 32, 80), True, 0, torch.bfloat16),
            ("lm_eval_f32", (16, 128, 32, 8, 128), True, 0,
             torch.float32),
            # the mma.sync tiles off the serving paths
            ("hd96", (4, 2048, 32, 32, 96), True, 0, torch.bfloat16),
            ("hd256", (4, 2048, 16, 8, 256), True, 0, torch.bfloat16)):
        nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * (
            2 if dt == torch.bfloat16 else 4)

        def make():
            return tuple((randn(*s) * 0.5).to(dt) for s in (
                (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        out[f"flash_{key}"] = cs.time_device(
            torch, lambda q, k, v: flash_attention(
                q, k, v, causal=causal, window=window),
            cs.cycled_inputs(make, nbytes))[0]

    def rwkv(B=4, T=2048, H=64, K=64, V=64):
        return ((randn(B, T, H, K) * 0.3).bfloat16(),
                (randn(B, T, H, K) * 0.3).bfloat16(),
                (randn(B, T, H, V) * 0.3).bfloat16(),
                -torch.rand(B, T, H, K, generator=gen, device=dev) * 1.2,
                randn(B, H, K, V) * 0.1, randn(H, K) * 0.2)

    def mamba(B=4, T=2048, H=40, K=64, V=128):
        """models/mamba.block's call form"""
        xc = (randn(B, T, H * V + 2 * K) * 0.3).bfloat16()
        dt_h = torch.nn.functional.softplus(randn(B, T, H) - 2.0)
        return (xc[..., H * V + K:].view(B, T, 1, K).expand(B, T, H, K),
                xc[..., H * V:H * V + K].view(B, T, 1, K)
                * dt_h[..., None].bfloat16(),
                xc[..., :H * V].view(B, T, H, V),
                -dt_h * torch.exp(randn(H) * 0.5),
                randn(B, H, K, V) * 0.1, None)

    for key, make, nbytes, inc, chunk in (
            ("rwkv6", rwkv, 411_100_000, False, 128),
            ("zamba2", mamba, 222_600_000, True, 128),
            # the 128-channel tiles, off the serving paths
            ("mamba2", lambda: mamba(H=80, K=128, V=64), 361_200_000, True,
             256),
            # 256 channels: the channel-block kernel in one block
            ("k256_mamba2", lambda: mamba(H=16, K=256, V=64), 113_700_000,
             True, 64),
            ("k256_rwkv6", lambda: rwkv(H=16, K=256, V=64), 310_400_000,
             False, 64)):
        # every kernel named chunk_scan_*, whichever of them the tree runs
        out[f"scan_{key}"] = cs.time_device(
            torch, lambda r, k, v, ld, s0, u: chunk_scan(
                r, k, v, ld, s0, bonus=u, chunk=chunk, include_current=inc),
            cs.cycled_inputs(make, nbytes), only="chunk_scan_")[0]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the other checkout's root")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the runs as JSON here")
    ap.add_argument("--tree", type=Path, default=None,
                    help=argparse.SUPPRESS)     # one run, in a subprocess
    args = ap.parse_args()
    if args.tree is not None:
        print("RUN " + json.dumps(time_tree(args.tree.resolve())),
              flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    order = (("parent", args.parent), ("change", ROOT), ("change", ROOT),
             ("parent", args.parent))
    for name, tree in order * ROUNDS:
        proc = subprocess.run(
            [sys.executable, __file__, "--parent", str(args.parent),
             "--tree", str(tree)], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RUN ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"the {name} run failed:\n{proc.stderr[-3000:]}")
        runs.append(dict(tree=name, **json.loads(lines[-1][4:])))
        print(json.dumps(runs[-1]), flush=True)
    ratios = {}
    for key in (k for k in runs[0] if k != "tree"):
        def mean(rs, tree):
            xs = [r[key] for r in rs if r["tree"] == tree]
            return sum(xs) / len(xs)
        rounds = [runs[4 * i:4 * i + 4] for i in range(ROUNDS)]
        ratios[key] = dict(
            rounds=[mean(r, "change") / mean(r, "parent") for r in rounds],
            all=mean(runs, "change") / mean(runs, "parent"))
        print(f"{key}: change / parent by round "
              + ", ".join(f"{x:.4f}" for x in ratios[key]["rounds"])
              + f"; over all rounds {ratios[key]['all']:.4f}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, runs=runs,
                                            ratios=ratios), indent=1))


if __name__ == "__main__":
    main()
