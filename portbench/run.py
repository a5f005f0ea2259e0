"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``clg_vqa_tpu_torch``),
on a machine with the cards the cell asks for. It makes its data and
weights from the seed, warms up, measures for ``--seconds``, checks what
the measured path produced against the plain reference in
``portbench/reference/``, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` (``--trace
1``) and ``checks``, each number compared beside its limit. It exits with
another code than 0, and prints no result, without CUDA or enough cards,
without the port, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if not os.path.isdir(os.path.join(ROOT, "clg_vqa_tpu_torch")):
        print("portbench: the port (clg_vqa_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import manifest, runner
    chips = next(w["chips"] for w in manifest.load(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # every rate and share of a peak is of this card at this power limit
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        print(f"portbench: card {smi}", file=sys.stderr)
    except (OSError, subprocess.TimeoutExpired):
        print("portbench: nvidia-smi gave no power limit", file=sys.stderr)
    res = runner.run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START, chips=chips)
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad[:10]}",
              file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
