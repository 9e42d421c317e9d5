"""The gate: ``python -m repro_torch.analysis`` — lint and kernel audit;
exits 1 on any finding.

Flags: ``--no-audit`` / ``--no-lint`` run one pass alone; ``--paths P
[P ...]`` lints another tree (default: the ``repro_torch`` package);
``--require-card`` makes the card checks' absence a failure. Without a card
those checks (each kernel's ``ptxas`` resources, the poisoned-allocator
coverage run) print as not run; with one, they run after the CPU checks
and print each kernel's registers, shared memory and spills, and the
contracts, cases and poisoned cells.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the kernel contract audit")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="files or directories to lint (default: the "
                         "repro_torch package)")
    ap.add_argument("--require-card", action="store_true",
                    help="fail when the card checks cannot run")
    args = ap.parse_args(argv)
    failures = 0

    if not args.no_lint:
        from repro_torch.analysis.lint import lint_paths

        paths = args.paths or [pathlib.Path(__file__).resolve().parent.parent]
        findings = lint_paths(paths)
        for f in findings:
            print(f"lint: {f}")
        print(f"lint: {len(findings)} finding(s)")
        failures += len(findings)

    if not args.no_audit:
        import torch

        from repro_torch.analysis.kernel_audit import audit_card, audit_registry
        from repro_torch.kernels.registry import collect

        reg = collect()
        report = audit_registry(reg)
        for f in report.findings:
            print(f"audit: {f}")
        print(f"audit (cpu): {report.kernels} contracts / {report.cases} "
              f"cases, {len(report.findings)} finding(s)")
        failures += len(report.findings)
        if torch.cuda.is_available():
            findings, rows, stats = audit_card(reg)
            for src, name, regs, smem, st, ld, inst in rows:
                print(f"resources: {src}.cu {name}: {regs} registers, "
                      f"{smem} bytes static smem, spills {st} / {ld} bytes "
                      f"stored / loaded ({inst} instances)")
            for f in findings:
                print(f"audit: {f}")
            print(f"audit (card, {torch.cuda.get_device_name(0)}): "
                  f"{len(rows)} kernels; {stats['contracts']} contracts / "
                  f"{stats['cases']} cases / {stats['runs']} runs, "
                  f"{stats['poisoned_cells']} poisoned cells; "
                  f"{len(findings)} finding(s)")
            failures += len(findings)
        else:
            print("audit (card): not run (no CUDA device): resources and "
                  "coverage unchecked")
            if args.require_card:
                print("audit (card): --require-card given and no card")
                failures += 1

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
