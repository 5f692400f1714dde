"""Scenario lab CLI of the port: the counterpart of tools/scenario_lab.py.

Runs every spec in the library directory (or a named subset) through
``gubernator_tpu_torch.scenarios.ScenarioRunner`` on ``--device``
(``cuda`` by default) and prints a verdict table: each scenario's
oracle results, decision digest, Jain's index where the fairness oracle
ran, the mesh stack's device list and the wall time.  Exit 0 when every
scenario's oracles pass.

Usage::

    python -m gubernator_tpu_torch.cmd.scenario_lab            # full library
    python -m gubernator_tpu_torch.cmd.scenario_lab --fast     # CI-speed twins
    python -m gubernator_tpu_torch.cmd.scenario_lab --only partition_reconcile
    python -m gubernator_tpu_torch.cmd.scenario_lab --list     # specs, catalogs
    python -m gubernator_tpu_torch.cmd.scenario_lab --json out.json
    python -m gubernator_tpu_torch.cmd.scenario_lab --device cpu

Environment: ``GUBER_SCENARIO_DIR`` relocates the library (default: the
repository's ``scenarios/``), ``GUBER_SCENARIO_FAST=1`` forces
``--fast``, ``GUBER_SCENARIO_SEED`` overrides every spec's seed.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the scenario-lab workload library on the port")
    ap.add_argument("--dir", default=None,
                    help="spec library (default: GUBER_SCENARIO_DIR "
                         "or scenarios/)")
    ap.add_argument("--only", action="append", default=None,
                    metavar="NAME", help="run only these spec names "
                    "(repeatable)")
    ap.add_argument("--fast", action="store_true",
                    help="apply each spec's fast-mode overrides")
    ap.add_argument("--json", metavar="PATH",
                    help="write the aggregate verdict document here")
    ap.add_argument("--list", action="store_true",
                    help="list specs, source kinds and oracles; no run")
    ap.add_argument("--device", default="cuda",
                    help="where the stacks serve: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import scenarios as scn

    specs = scn.load_library(args.dir)
    if args.only:
        known = {s.name for s in specs}
        missing = set(args.only) - known
        if missing:
            print(f"unknown scenario(s): {sorted(missing)} "
                  f"(library has {sorted(known)})")
            return 2
        specs = [s for s in specs if s.name in args.only]

    if args.list:
        print(f"library: {args.dir or scn.default_scenario_dir()}")
        for s in specs:
            print(f"  {s.name:24s} stack={s.stack:9s} "
                  f"oracles={','.join(s.oracles)}")
        print("source kinds:")
        for k, v in scn.SOURCE_KINDS.items():
            print(f"  {k:12s} {v}")
        print("oracles:")
        for k, v in scn.ORACLE_KINDS.items():
            print(f"  {k:14s} {v}")
        return 0

    fast = args.fast or scn.env_fast()
    doc = scn.run_scenarios(
        specs, fast=fast, device=args.device,
        progress=lambda s: print(f"-- {s.name} ({s.stack}) ...",
                                 flush=True))
    for name, row in doc["scenarios"].items():
        mark = "ok " if row["ok"] else "FAIL"
        extra = ""
        if "jain_index" in row:
            extra += f" jain={row['jain_index']}"
        if "mesh_devices" in row:
            extra += f" mesh={','.join(row['mesh_devices'])}"
        oracles = " ".join(k + ("+" if v["ok"] else "!")
                           for k, v in row["oracles"].items())
        print(f"  {mark} {name:24s} reqs={row['requests']:<6d} "
              f"digest={row['decision_digest'][:12]}"
              f" oracles=[{oracles}] wall_ms={row['wall_ms']}{extra}")
    print(f"{doc['count']} scenarios on {args.device}, "
          f"all_ok={doc['all_ok']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    return 0 if doc["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
