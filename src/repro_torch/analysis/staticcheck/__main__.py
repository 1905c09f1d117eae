"""CLI: ``python -m repro_torch.analysis.staticcheck [--json] [--no-engines]
[--no-collectives] [--no-costmodel] [--device D] [--root DIR]``. Exit
status 1 when any finding survives, 0 on a clean tree. ``--device``
defaults to the card, as every entry point of the port does; ``--device
cpu`` runs every pass on the CPU. ``--json`` also carries the collective
sequences, the steps' host syncs, the launches and the cost report."""
from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="op contracts + retrace detector + architecture lint + "
                    "collective safety + cost model",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--no-engines", action="store_true",
                    help="skip the live engine probe (also skips the "
                         "collective-safety and cost-model passes, which read it)")
    ap.add_argument("--no-collectives", action="store_true",
                    help="skip the collective-safety pass over the sharded probe")
    ap.add_argument("--no-costmodel", action="store_true",
                    help="skip the cost model (budgets.json and the "
                         "linear-memory probe)")
    ap.add_argument("--device", default=None,
                    help="device to run the ops and probes on (default: the card)")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="repo root (default: inferred from this file)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.staticcheck import report_json, run_all

    reports: dict = {}
    findings = run_all(
        args.root,
        device=args.device,
        engines=not args.no_engines,
        collectives=not args.no_collectives,
        costs=not args.no_costmodel,
        reports=reports,
    )
    reports.pop("traces", None)
    if args.json:
        print(report_json(findings, extras=reports))
    else:
        for f in findings:
            print(f)
        print(f"staticcheck: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
