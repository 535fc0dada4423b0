"""CLI: python -m vega_tpu_torch.lint [paths...] [--output text|json]
[--json-out PATH] [--select VG002,VG003] [--list-rules] [--no-cache]
[--changed] [--explain-role module.fn]

Exit status: 0 clean, 1 unsuppressed findings (or unparseable files),
2 usage error. --json-out writes the machine-readable finding JSON
(stable schema: engine.JSON_SCHEMA) for CI artifact pickup.

--changed lints only files modified since the last CLEAN full sweep
(the stamp rides next to the result cache): nothing changed is an
instant pass; a change under vega_tpu_torch/ falls back to the full sweep
(the project call graph's inputs changed); otherwise only the per-file
rules run on the changed files (project rules and the VG000
orphan-pragma check need full-tree context, so pre-commit speed trades
them away — a gate keeps the full sweep).

--explain-role prints the thread role(s) a function resolves to in the
project call graph plus one witness call path per role — the debugging
lens for VG016/VG019 findings.
"""

from __future__ import annotations

import argparse
import json
import sys

from vega_tpu_torch.lint.engine import (
    JSON_SCHEMA,
    NOT_PORTED,
    all_rules,
    changed_since_stamp,
    gather_extracts,
    render_json,
    render_text,
    run_lint,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vega_tpu_torch.lint",
        description="vegalint: machine-checked vega_tpu_torch invariants "
                    "(catalog: --list-rules)")
    parser.add_argument("paths", nargs="*",
                        default=["vega_tpu_torch", "chip_smoke.py"],
                        help="files or directories (default: the port's "
                             "sweep set)")
    parser.add_argument("--format", "--output", dest="format",
                        choices=("text", "json"), default="text",
                        help="stdout format (--output is an alias)")
    parser.add_argument("--json-out", default=None, metavar="PATH",
                        help="additionally write the JSON report (stable "
                             "finding schema) to PATH — CI artifact")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run (default: "
                             "all)")
    parser.add_argument("--no-cache", action="store_true",
                        help="bypass the mtime-keyed result cache")
    parser.add_argument("--changed", action="store_true",
                        help="lint only files changed since the last "
                             "clean full sweep (falls back to full when "
                             "vega_tpu_torch/ itself changed or no stamp "
                             "exists)")
    parser.add_argument("--explain-role", default=None, metavar="FN",
                        help="print the role(s) a function (module.fn "
                             "or Class.method suffix) resolves to, with "
                             "one witness call path per role")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid, r in sorted(all_rules().items()):
            print(f"{rid}  {r.title}")
            doc = " ".join((r.doc or "").split())
            if doc:
                print(f"       {doc}")
        print(f"{NOT_PORTED[0]}  (not ported) {NOT_PORTED[1]}")
        return 0

    if args.explain_role:
        from vega_tpu_torch.lint import callgraph

        records = gather_extracts(args.paths, "callgraph",
                                  cache=not args.no_cache)
        matches = callgraph.explain(records, args.explain_role)
        if args.format == "json":
            print(json.dumps({"schema": JSON_SCHEMA,
                              "query": args.explain_role,
                              "matches": matches},
                             indent=1, sort_keys=True))
        else:
            for m in matches:
                print(f"{m['function']}  ({m['file']}:{m['line']})")
                if not m["roles"]:
                    print("    roles: none (driver-api by default)")
                for role, path in m["roles"].items():
                    print(f"    {role}: {' -> '.join(path)}")
            if not matches:
                print(f"no function matching {args.explain_role!r} in "
                      "the call graph", file=sys.stderr)
        return 0 if matches else 2

    select = [s.strip() for s in args.select.split(",")] \
        if args.select else None
    if args.changed and select is None:
        changed = changed_since_stamp(args.paths)
        if changed is not None:
            if any("/vega_tpu_torch/" in "/" + p.replace("\\", "/").lstrip("./")
                   for p in changed):
                pass  # graph inputs changed: keep the full sweep
            else:
                # Narrow run: per-file rules on just the changed files.
                # A clean narrow run does NOT move the stamp (only a
                # full sweep proves the tree clean).
                args.paths = changed
                select = [rid for rid, r in all_rules().items()
                          if not r.project]
    try:
        result = run_lint(args.paths, select=select,
                          cache=not args.no_cache)
    except ValueError as exc:  # unknown --select rule id
        print(f"vegalint: {exc}", file=sys.stderr)
        return 2
    if args.json_out:
        try:
            with open(args.json_out, "w", encoding="utf-8") as f:
                f.write(render_json(result) + "\n")
        except OSError as exc:
            # The artifact is a convenience copy; an IO failure (foreign
            # file in a shared temp dir, read-only fs) must not make a
            # clean tree look like a failed gate.
            print(f"vegalint: could not write --json-out artifact: {exc}",
                  file=sys.stderr)
    print(render_json(result) if args.format == "json"
          else render_text(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
