"""Unbounded fuzz soak + one-line failure reproduction, on the port.

The counterpart of ``benchmarks/fuzz_soak.py`` (the JAX package) over
``repro_torch.scenarios.fuzz``: the same flags, the same JSON failure record
and the same exit status.  Numeric modes (cluster, kernel, chaos) run on the
card, each cluster held to its CPU twin by the kernel-consistency checker;
without a card they fail.

Nightly CI runs this with a large trace budget; every failure is greedily
minimized (single-event deletion, legality re-checked per candidate) and
written as a JSON artifact carrying the seed, the policy, the error, the
minimized trace, and the exact repro command.

Usage:
    PYTHONPATH=src python -m benchmarks.torch_fuzz_soak --traces 2000 \
        --numeric-traces 40 --out fuzz_artifacts
    PYTHONPATH=src python -m benchmarks.torch_fuzz_soak --mode analytic \
        --seed 17 --policy oobleck   # reproduce one failure (the printed line)

Exit status is the number of failing (seed, policy) pairs (0 = clean soak).
Not registered in benchmarks/run.py: this is correctness tooling, not a
paper figure.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import traceback

from repro_torch.scenarios import (POLICY_NAMES, make_case, run_case,
                                   run_chaos_case, shrink_case)


def _case_record(case, policy, err):
    rec = {
        "seed": case.seed,
        "mode": case.mode,
        "policy": policy,
        "workload": case.workload.describe(),
        "horizon": case.scenario.horizon,
        "events": [e.describe() for e in case.scenario.events],
        "error": str(err),
        "repro": case.repro(policy),
    }
    if case.mode == "chaos":
        rec["chaos_class"] = case.chaos_class
        rec["actions"] = [f"step={a.step} {a.kind} rank={a.rank}"
                          for a in case.actions]
    return rec


def _run(case, policy):
    if case.mode == "chaos":
        run_chaos_case(case)            # perturbed-detection-plane property
    else:
        run_case(case, policy=policy)   # perfectly-detected trace invariants


def _soak_one(mode: str, seed: int, policy, out_dir, minimize: bool):
    """Returns None on success, else the JSON failure record."""
    case = make_case(mode, seed)
    try:
        _run(case, policy)
        return None
    except Exception as err:                                # noqa: BLE001
        first_err = err

    rec = _case_record(case, policy, first_err)
    if minimize and mode != "chaos":    # chaos repro = seed, nothing to shrink
        def fails(c):
            try:
                run_case(c, policy=policy)
                return False
            except Exception:                               # noqa: BLE001
                return True

        small = shrink_case(case, fails)
        rec["minimized_events"] = [e.describe()
                                   for e in small.scenario.events]
        rec["minimized_from"] = len(case.scenario.events)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"fuzz-{mode}-{seed}-{policy or 'default'}.json"
        path.write_text(json.dumps(rec, indent=2))
        rec["artifact"] = str(path)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=200,
                    help="analytic trace budget (x all three policies)")
    ap.add_argument("--numeric-traces", type=int, default=0,
                    help="numeric (VirtualCluster on the card, tiny dense) "
                         "trace budget — slow: every step runs a CPU twin")
    ap.add_argument("--kernel-traces", type=int, default=0,
                    help="kernel-mode numeric trace budget (dense or ssm "
                         "drawn, tolerance-tier invariant 1) — slow, like "
                         "--numeric-traces")
    ap.add_argument("--chaos-traces", type=int, default=0,
                    help="detection-chaos trace budget (VirtualCluster under "
                         "dropped/delayed/duplicated/flapping probes and "
                         "corrupted snapshot shards) — slow, like "
                         "--numeric-traces")
    ap.add_argument("--base-seed", type=int, default=0,
                    help="first seed of the sweep")
    ap.add_argument("--seed", type=int, default=None,
                    help="reproduce exactly one seed and exit")
    ap.add_argument("--mode",
                    choices=("analytic", "cluster", "kernel", "chaos"),
                    default="analytic", help="mode for --seed repro runs")
    ap.add_argument("--policy", choices=POLICY_NAMES, default=None,
                    help="restrict to one policy (analytic mode)")
    ap.add_argument("--out", default="fuzz_artifacts",
                    help="directory for minimized-failure JSON artifacts")
    ap.add_argument("--no-minimize", action="store_true",
                    help="skip greedy trace minimization on failure")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    minimize = not args.no_minimize

    if args.seed is not None:               # one-line failure reproduction
        case = make_case(args.mode, args.seed)
        print(f"# {case.mode} seed {args.seed}: horizon "
              f"{case.scenario.horizon}, workload {case.workload.describe()}")
        for e in case.scenario.events:
            print(f"#   {e.describe()}")
        if args.mode == "chaos":
            print(f"# chaos class {case.chaos_class}; ground truth:")
            for a in case.actions:
                print(f"#   step={a.step} {a.kind} rank={a.rank}")
        policies = ([args.policy] if args.policy
                    else (list(POLICY_NAMES) if args.mode == "analytic"
                          else [None]))
        status = 0
        for pol in policies:
            try:
                _run(case, pol)
                print(f"PASS {pol or args.mode}")
            except Exception:                               # noqa: BLE001
                traceback.print_exc()
                status += 1
        return status

    failures = []
    runs = 0
    plan = [("analytic", args.traces,
             [args.policy] if args.policy else list(POLICY_NAMES)),
            ("cluster", args.numeric_traces, [None]),
            ("kernel", args.kernel_traces, [None]),
            ("chaos", args.chaos_traces, [None])]
    for mode, budget, policies in plan:
        for i in range(budget):
            seed = args.base_seed + i
            for pol in policies:
                runs += 1
                rec = _soak_one(mode, seed, pol, out_dir, minimize)
                if rec is not None:
                    failures.append(rec)
                    n_min = len(rec.get("minimized_events",
                                        rec["events"]))
                    print(f"FAIL {mode} seed {seed} "
                          f"policy={pol or mode} "
                          f"({rec.get('minimized_from', '?')}"
                          f" -> {n_min} events)\n  {rec['repro']}",
                          file=sys.stderr)
    print(f"fuzz soak: {runs} runs, {len(failures)} failures"
          + (f" (artifacts in {out_dir})" if failures else ""))
    return len(failures)


if __name__ == "__main__":
    raise SystemExit(main())
