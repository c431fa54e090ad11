"""Shared finding/severity model for the ytpu-lint static-analysis suite.

One :class:`Finding` per rule violation, carrying the rule id, severity,
location, the enclosing symbol (``Class.method`` or module), and a
stable *fingerprint* — a keyed hash of (rule, path, symbol, message)
that deliberately excludes line numbers, so a committed baseline entry
survives unrelated edits to the same file.

Suppressions are inline comments, pylint-style but project-native::

    x = donated_call(buf)  # ytpu-lint: disable=donation-aliasing -- reason
    # ytpu-lint: disable-next-line=lock-discipline -- benign racy precheck
    # ytpu-lint: disable-file=retrace-hazard -- generated shim

A suppression MUST carry a ``-- reason`` string; a bare disable is
itself reported (rule ``bare-suppression``), and a disable that matched
no finding is reported as ``useless-suppression`` — so every committed
suppression is load-bearing and self-documenting, and deleting any one
of them reproduces the original finding.
"""

from __future__ import annotations

import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from hashlib import blake2b
from pathlib import Path

SEVERITIES = ("advice", "warning", "error")

# meta-rules emitted by the runner itself (not a checker)
RULE_USELESS_SUPPRESSION = "useless-suppression"
RULE_BARE_SUPPRESSION = "bare-suppression"
RULE_PARSE_ERROR = "parse-error"

_SUPPRESS_RE = re.compile(
    r"#\s*ytpu-lint:\s*"
    r"(?P<kind>disable|disable-next-line|disable-file)\s*=\s*"
    r"(?P<rules>[a-z0-9_,\- ]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)


@dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    symbol: str = ""   # enclosing "Class.method" / "function" / ""
    col: int = 0

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity for baseline matching."""
        h = blake2b(digest_size=8, person=b"ytpu-lint")
        for part in (self.rule, self.path, self.symbol, self.message):
            h.update(part.encode("utf-8", "replace"))
            h.update(b"\x00")
        return h.hexdigest()

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.severity}: {self.rule}: {self.message}{sym}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "symbol": self.symbol,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


@dataclass
class Suppression:
    """One parsed ``# ytpu-lint: disable…`` comment."""

    path: str
    line: int            # line the comment sits on
    kind: str            # disable | disable-next-line | disable-file
    rules: tuple
    reason: str
    used: bool = field(default=False, compare=False)

    @property
    def target_line(self) -> int | None:
        """The source line this suppression covers (None = whole file)."""
        if self.kind == "disable":
            return self.line
        if self.kind == "disable-next-line":
            return self.line + 1
        return None

    def covers(self, finding: Finding) -> bool:
        if finding.path != self.path:
            return False
        if finding.rule not in self.rules and "all" not in self.rules:
            return False
        target = self.target_line
        return target is None or target == finding.line


def parse_suppressions(path: str, text: str) -> list[Suppression]:
    """Suppressions from real COMMENT tokens only — a ``# ytpu-lint:``
    example quoted inside a docstring is documentation, not a disable."""
    if "ytpu-lint" not in text:
        return []
    out = []
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(text).readline)
        )
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return []
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "ytpu-lint" not in tok.string:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        out.append(
            Suppression(
                path=path,
                line=tok.start[0],
                kind=m.group("kind"),
                rules=rules,
                reason=(m.group("reason") or "").strip(),
            )
        )
    return out


class Baseline:
    """Committed fingerprints of grandfathered findings.

    The file is a JSON list of entries ``{"fingerprint", "rule", "path",
    "symbol", "message", "note"}``; everything except the fingerprint is
    for the human reading the diff.  An entry that matches no live
    finding is *stale* and reported, so the baseline can only shrink."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = list(entries or [])
        self._by_fp = {e["fingerprint"]: e for e in self.entries}
        self.matched: set[str] = set()

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        p = Path(path)
        if not p.exists():
            return cls([])
        return cls(json.loads(p.read_text()))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(self.entries, indent=1, sort_keys=True) + "\n"
        )

    def covers(self, finding: Finding) -> bool:
        fp = finding.fingerprint
        if fp in self._by_fp:
            self.matched.add(fp)
            return True
        return False

    def stale_entries(self) -> list[dict]:
        return [
            e for e in self.entries if e["fingerprint"] not in self.matched
        ]

    @staticmethod
    def entry_for(finding: Finding, note: str = "") -> dict:
        return {
            "fingerprint": finding.fingerprint,
            "rule": finding.rule,
            "path": finding.path,
            "symbol": finding.symbol,
            "message": finding.message,
            "note": note,
        }
