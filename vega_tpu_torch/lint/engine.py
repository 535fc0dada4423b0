"""vegalint core: file model, rule registry, pragma handling, cache,
reporters.

Pure stdlib (ast + re + pickle) — the linter must run in well under ten
seconds on one core and must not import torch or any vega_tpu_torch
runtime module (it lints source trees it never executes).

Rule protocol
-------------
A rule is registered with :func:`rule` and comes in two shapes:

* per-file: ``check(FileCtx) -> findings`` — runs once per file; its
  findings are cached per file.
* project (``project=True``): a cheap per-file ``extract(FileCtx) ->
  data`` (cached per file, shareable between rules via ``extract_key``)
  plus a global ``check(records) -> findings`` combining every file's
  extraction — the two-pass shape the cross-file analyses (lock-order
  VG003, the VG009–VG011 contract index) need. ``records`` is a list of
  ``(display, data)`` pairs for files whose extraction returned data.

Result cache
------------
Parsing ~100 files and walking their ASTs dominates the sweep, so
:func:`run_lint` keeps a pickle cache keyed on each file's
``(mtime_ns, size)`` plus a fingerprint of the engine/rules sources:
an unchanged file contributes its cached per-file findings, pragmas and
project-rule extractions without being re-read or re-parsed — only the
cheap global combine runs every time. ``VEGA_TPU_LINT_CACHE`` overrides
the cache path ("0"/"off" disables; this package appends ``.torch``);
``--no-cache`` disables per run. The cache file is named for this
package, so it never shares a file with vega_tpu's vegalint linting the
same checkout (whose records the other's fingerprint would discard).

Pragmas
-------
A finding on line N is suppressed when line N — or a standalone comment
line directly above it — carries::

    # vegalint: ignore[VG003] — one-line justification

The justification is MANDATORY: a pragma without one is itself a finding
(VG000, not suppressible), which is how the acceptance criterion "every
ignore carries a justification" is machine-enforced rather than reviewed.
``ignore[*]`` suppresses every rule on that line (same justification
duty). A pragma that no longer suppresses anything is reported WITH its
orphaned justification text, so stale pragmas cannot silently rot after
a refactor moves or fixes the code they annotated.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import hashlib
import io
import json
import os
import pickle
import re
import sys
import tempfile
import tokenize
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

PRAGMA_RE = re.compile(
    r"#\s*vegalint:\s*ignore\[([^\]]*)\]\s*(.*)$"
)
# Leading em-dash / dash / colon before the justification text.
_JUSTIFY_STRIP = " \t—–:-"

# The one rule of vega_tpu's vegalint with no counterpart here.
NOT_PORTED = ("VG001", "raw jax compat-surface spelling outside "
              "tpu/compat.py — the port has no jax, and vega_tpu's "
              "tpu/compat.py is not ported by design")

# Stable schema version of the JSON reporter output (finding dicts carry
# rule / path / line / col / message / suppressed / justification).
# Schema 2 (vegalint v3): same finding shape as schema 1 — the bump marks
# the addition of the `--explain-role` document ({schema, query, matches})
# sharing the version number; consumers of the sweep document need no
# changes beyond accepting schema == 2.
JSON_SCHEMA = 2


@dataclasses.dataclass
class Finding:
    rule: str
    path: str  # as given on the command line (relative where possible)
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.justification is None:
            d.pop("justification")
        # "pragma state" for CI artifact consumers: suppressed findings
        # carry their justification, live ones carry "none".
        d["pragma"] = "justified" if self.suppressed else "none"
        return d

    def render(self) -> str:
        tag = " (suppressed: %s)" % self.justification if self.suppressed \
            else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}{tag}"


@dataclasses.dataclass
class Rule:
    id: str
    title: str
    doc: str  # rationale + example, surfaced by --list-rules and the docs
    check: Callable
    project: bool = False  # True: check(records); else check(FileCtx)
    extract: Optional[Callable] = None  # project rules: extract(FileCtx)
    extract_key: Optional[str] = None  # share one extraction across rules


_RULES: Dict[str, Rule] = {}


def rule(rule_id: str, title: str, doc: str = "", project: bool = False,
         extract: Optional[Callable] = None,
         extract_key: Optional[str] = None):
    def register(fn):
        _RULES[rule_id] = Rule(rule_id, title, doc or (fn.__doc__ or ""),
                               fn, project, extract, extract_key)
        return fn

    return register


def all_rules() -> Dict[str, Rule]:
    # Importing the rules module populates the registry on first use.
    from vega_tpu_torch.lint import rules  # noqa: F401

    return dict(_RULES)


class FileCtx:
    """One parsed source file plus the import-alias map rules share."""

    def __init__(self, path: str, display: str, source: str):
        self.path = path
        self.display = display  # normalized, '/'-separated, for reporting
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = _collect_aliases(self.tree)
        # pragma line -> (set of rule ids or {'*'}, justification, col,
        # standalone). Pragmas are read from real COMMENT tokens, so a
        # docstring that *mentions* the syntax (this engine's own, say)
        # is not a pragma. `standalone` records whether the pragma is a
        # comment-only line (then it also covers the line below).
        self.pragmas: Dict[int, Tuple[set, str, int, bool]] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = PRAGMA_RE.search(tok.string)
                if m:
                    ids = {s.strip() for s in m.group(1).split(",")
                           if s.strip()}
                    just = m.group(2).strip(_JUSTIFY_STRIP).strip()
                    line = tok.start[0]
                    text = self.lines[line - 1].lstrip() \
                        if 1 <= line <= len(self.lines) else ""
                    self.pragmas[line] = (
                        ids, just, tok.start[1] + m.start() + 1,
                        text.startswith("#"))
        except tokenize.TokenError:
            pass  # the ast parse already succeeded; just no pragmas

    # ---------------------------------------------------------- path scoping
    def in_dir(self, *parts: str) -> bool:
        """True when the file lives under a directory path containing the
        given '/'-joined fragment (e.g. in_dir('vega_tpu_torch', 'shuffle'))."""
        return "/" + "/".join(parts) + "/" in "/" + self.display

    def endswith(self, suffix: str) -> bool:
        return self.display.endswith(suffix)

    @property
    def module(self) -> str:
        """Dotted module name anchored at the last 'vega_tpu_torch' path
        segment (lock keys and messages use it); top-level scripts use the
        stem."""
        parts = self.display.split("/")
        anchors = [i for i, p in enumerate(parts[:-1])
                   if p == "vega_tpu_torch"]
        if anchors:
            parts = parts[anchors[-1]:]
        if parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    # ----------------------------------------------------------- ast helpers
    def qualified(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with import aliases
        expanded: `F.pad` -> 'torch.nn.functional.pad' after
        `import torch.nn.functional as F`."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id, node.id)
        return ".".join([base] + list(reversed(parts)))


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


# --------------------------------------------------------------- file records
@dataclasses.dataclass
class FileRecord:
    """Everything a single file contributes to a lint run — the cacheable
    unit. `findings` holds every per-file rule's output (select filters at
    assembly time, so one cache serves every --select subset); `extracts`
    holds the project rules' per-file extraction data."""

    display: str
    stat: Tuple[int, int]  # (mtime_ns, size)
    error: Optional[str] = None
    pragmas: Dict[int, Tuple[set, str, int, bool]] = \
        dataclasses.field(default_factory=dict)
    findings: List[Finding] = dataclasses.field(default_factory=list)
    extracts: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _build_record(path: str, display: str, stat: Tuple[int, int],
                  rules: Dict[str, Rule]) -> FileRecord:
    rec = FileRecord(display, stat)
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        ctx = FileCtx(path, display, source)
    except (SyntaxError, UnicodeDecodeError, OSError) as exc:
        rec.error = f"{display}: {type(exc).__name__}: {exc}"
        return rec
    rec.pragmas = dict(ctx.pragmas)
    extractors: Dict[str, Callable] = {}
    for r in rules.values():
        if not r.project:
            rec.findings.extend(r.check(ctx))
        elif r.extract is not None:
            extractors.setdefault(r.extract_key or r.id, r.extract)
    for key, fn in extractors.items():
        data = fn(ctx)
        if data is not None:
            rec.extracts[key] = data
    return rec


# --------------------------------------------------------------- result cache
def _cache_path() -> Optional[str]:
    override = os.environ.get("VEGA_TPU_LINT_CACHE")
    if override is not None:
        if override.strip().lower() in ("", "0", "off", "none"):
            return None
        return override + ".torch"  # never vega_tpu's linter's file
    # Default location: a PRIVATE per-user directory (0700, ownership
    # verified) under the temp dir. pickle.load executes arbitrary code,
    # so a predictable world-writable path would let any local user plant
    # a payload for the next lint run — if the directory is foreign or
    # group/world-accessible, run uncached instead.
    uid = getattr(os, "getuid", lambda: 0)()
    base = os.path.join(tempfile.gettempdir(), f"vegalint-{uid}")
    try:
        os.makedirs(base, mode=0o700, exist_ok=True)
        st = os.stat(base)
        if st.st_uid != uid or (st.st_mode & 0o077):
            return None
    except OSError:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tag = hashlib.sha1(root.encode()).hexdigest()[:12]
    return os.path.join(base, f"torch-cache-{tag}.pkl")


def _cache_fingerprint() -> str:
    """Any change to the engine or the rules invalidates every cached
    record — rule logic is part of the result."""
    parts = ["schema=2", "package=vega_tpu_torch",
             f"py={sys.version_info[:2]}"]
    from vega_tpu_torch.lint import callgraph as cg_mod
    from vega_tpu_torch.lint import rules as rules_mod

    for mod_file in (os.path.abspath(__file__),
                     os.path.abspath(rules_mod.__file__),
                     os.path.abspath(cg_mod.__file__)):
        try:
            st = os.stat(mod_file)
            parts.append(f"{mod_file}:{st.st_mtime_ns}:{st.st_size}")
        except OSError:
            parts.append(f"{mod_file}:?")
    return "|".join(parts)


def _load_cache(cache_file: str, fingerprint: str) -> Dict:
    try:
        with open(cache_file, "rb") as f:
            blob = pickle.load(f)
        if blob.get("fp") == fingerprint:
            return blob["records"]
    except Exception:  # corrupt/foreign cache: start cold
        pass
    return {}


def _save_cache(cache_file: str, fingerprint: str, records: Dict) -> None:
    # Prune records for files that no longer exist so fixture churn from
    # test runs cannot grow the cache without bound.
    live = {k: v for k, v in records.items() if os.path.exists(k[0])}
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache_file),
                                   prefix=".vegalint-")
        with os.fdopen(fd, "wb") as f:
            pickle.dump({"fp": fingerprint, "records": live}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_file)
    except OSError:
        pass  # caching is best-effort; the sweep result is unaffected


# ------------------------------------------------------------- clean stamp
# `--changed` lints only files modified since the last
# CLEAN full sweep. The stamp rides next to the result cache (same
# private-dir guarantees); no stamp (or cache disabled) means --changed
# degrades to the full sweep, never to a vacuous pass.
def clean_stamp_path() -> Optional[str]:
    cp = _cache_path()
    return cp + ".stamp" if cp else None


def write_clean_stamp() -> None:
    sp = clean_stamp_path()
    if sp is None:
        return
    try:
        with open(sp, "w") as f:
            f.write("clean full sweep marker (mtime is the stamp)\n")
    except OSError:
        pass


def read_clean_stamp() -> Optional[int]:
    """mtime_ns of the last clean full sweep, or None."""
    sp = clean_stamp_path()
    if sp is None:
        return None
    try:
        return os.stat(sp).st_mtime_ns
    except OSError:
        return None


def changed_since_stamp(paths: Iterable[str]) -> Optional[List[str]]:
    """Files under `paths` modified after the last clean full sweep, or
    None when no stamp exists (caller must fall back to a full sweep)."""
    stamp = read_clean_stamp()
    if stamp is None:
        return None
    out: List[str] = []
    for path in discover(paths):
        try:
            if os.stat(path).st_mtime_ns > stamp:
                out.append(path)
        except OSError:
            out.append(path)  # vanished/ephemeral: let the sweep report it
    return out


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]  # unsuppressed, reported, gate exit status
    suppressed: List[Finding]
    files: int
    errors: List[str]  # unparseable files etc.
    cache_hits: int = 0  # files served from the mtime-keyed result cache

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def to_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "schema": JSON_SCHEMA,
            "ok": self.ok,
            "files": self.files,
            "cache_hits": self.cache_hits,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "errors": self.errors,
            "by_rule": counts,
        }


def discover(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def _collect_records(paths: List[str], build_rules: Dict[str, Rule],
                     cache: bool, errors: List[str]
                     ) -> Tuple[List[FileRecord], int]:
    """The discovery + mtime-cache loop shared by run_lint and the
    --explain-role record gatherer."""
    cache_file = _cache_path() if cache else None
    fingerprint = _cache_fingerprint() if cache_file else ""
    store: Dict = _load_cache(cache_file, fingerprint) if cache_file else {}
    dirty = False
    cache_hits = 0
    records: List[FileRecord] = []
    for path in discover(paths):
        display = os.path.normpath(path).replace(os.sep, "/")
        try:
            st = os.stat(path)
        except OSError as exc:
            errors.append(f"{display}: OSError: {exc}")
            continue
        stat = (st.st_mtime_ns, st.st_size)
        key = (os.path.abspath(path), display)
        rec = store.get(key)
        if rec is not None and rec.stat == stat:
            cache_hits += 1
        else:
            rec = _build_record(path, display, stat, build_rules)
            store[key] = rec
            dirty = True
        records.append(rec)
    if cache_file and dirty:
        _save_cache(cache_file, fingerprint, store)
    return records, cache_hits


def gather_extracts(paths: Iterable[str], extract_key: str,
                    cache: bool = True) -> List[Tuple[str, Any]]:
    """The (display, data) pairs a project rule's global combine would
    see — the record source for `--explain-role` (and tests that poke the
    call graph directly)."""
    errors: List[str] = []
    records, _hits = _collect_records(list(paths), all_rules(), cache,
                                      errors)
    return [(rec.display, rec.extracts[extract_key]) for rec in records
            if not rec.error and extract_key in rec.extracts]


def run_lint(paths: Iterable[str],
             select: Optional[Iterable[str]] = None,
             cache: bool = True) -> LintResult:
    rules = all_rules()
    if select:
        keep = set(select)
        unknown = keep - set(rules)
        if unknown:
            # A typo'd --select silently checking nothing would report the
            # invariant gate green — fail loudly instead.
            raise ValueError(f"unknown rule id(s) in select: "
                             f"{sorted(unknown)}; known: {sorted(rules)}")
    errors: List[str] = []
    paths = list(paths)
    for p in paths:
        # Same rationale: a mistyped path must not make the gate pass
        # vacuously.
        if not os.path.exists(p):
            errors.append(f"{p}: path does not exist")
        elif not os.path.isdir(p) and not p.endswith(".py"):
            errors.append(f"{p}: not a directory or .py file")

    active = rules if not select else \
        {rid: r for rid, r in rules.items() if rid in set(select)}
    # Records built for the cache run EVERY rule (one cache serves every
    # --select subset); with no cache to fill, building unselected rules'
    # results would be pure waste — narrow to the active set.
    build_rules = rules if cache else active
    records, cache_hits = _collect_records(paths, build_rules, cache,
                                           errors)

    raw: List[Finding] = []
    for rec in records:
        if rec.error:
            errors.append(rec.error)
            continue
        # Copies: cached Finding objects must never be mutated by pragma
        # application (the cache would leak one run's suppression state
        # into the next).
        raw.extend(copy.copy(f) for f in rec.findings if f.rule in active)
    for r in active.values():
        if not r.project:
            continue
        key = r.extract_key or r.id
        data = [(rec.display, rec.extracts[key]) for rec in records
                if not rec.error and key in rec.extracts]
        raw.extend(r.check(data))

    by_display = {rec.display: rec for rec in records if not rec.error}
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    used_pragmas: Dict[Tuple[str, int], bool] = {}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        rec = by_display.get(f.path)
        hit = _pragma_for(rec, f) if rec is not None else None
        if hit is not None and f.rule != "VG000":
            line, (_ids, just, _col, _standalone) = hit
            used_pragmas[(f.path, line)] = True
            f.suppressed = True
            f.justification = just or None
            suppressed.append(f)
        else:
            findings.append(f)

    # Pragma hygiene (VG000): a pragma must carry a justification; a pragma
    # that names no known rule, or suppresses nothing, is dead weight —
    # either the invariant code was fixed (delete the pragma) or the rule
    # drifted (fix the rule). Not themselves suppressible.
    known = set(rules) | {"*"}
    for rec in records:
        if rec.error:
            continue
        for line, (ids, just, col, _standalone) in sorted(
                rec.pragmas.items()):
            if not just:
                findings.append(Finding(
                    "VG000", rec.display, line, col,
                    "pragma without justification — write "
                    "'# vegalint: ignore[RULE] — why this is safe'"))
            unknown = ids - known
            if unknown:
                findings.append(Finding(
                    "VG000", rec.display, line, col,
                    f"pragma names unknown rule(s) {sorted(unknown)}"))
            elif select is None \
                    and not used_pragmas.get((rec.display, line)):
                findings.append(Finding(
                    "VG000", rec.display, line, col,
                    f"pragma suppresses nothing (rules {sorted(ids)} did "
                    "not fire here) — delete it or re-anchor it; orphaned "
                    f"justification: {just!r}"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    result = LintResult(findings, suppressed,
                        len([r for r in records if not r.error]), errors,
                        cache_hits=cache_hits)
    # A clean FULL sweep (every rule, cache on) arms `--changed`: only a
    # run that proved the whole tree clean may move the stamp.
    if select is None and cache and result.ok:
        write_clean_stamp()
    return result


def _pragma_for(rec: FileRecord, f: Finding):
    """Pragma applying to finding `f`: same line, or a standalone comment
    line directly above."""
    for line in (f.line, f.line - 1):
        hit = rec.pragmas.get(line)
        if hit is None:
            continue
        if line == f.line - 1 and not hit[3]:
            continue  # trailing pragma on the previous code line
        ids = hit[0]
        if f.rule in ids or "*" in ids:
            return line, hit
    return None


# ------------------------------------------------------------------ reporters
def render_text(result: LintResult) -> str:
    lines = [f.render() for f in result.findings]
    lines.extend(f"error: {e}" for e in result.errors)
    lines.append(
        f"vegalint: {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed, {result.files} file(s), "
        f"{result.cache_hits} cached"
    )
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    return json.dumps(result.to_dict(), indent=1, sort_keys=True)
