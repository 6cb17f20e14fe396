"""TEMPO/TEMPO2/PINT-style parfile parsing.

A parfile is a sequence of ``NAME value [fit-flag] [uncertainty]`` lines, plus
repeatable lines (JUMP, ECORR, ...) that carry selection clauses, e.g.
``JUMP -fe L-wide 0.1 1``. The reference parses these in
pint/models/model_builder.py:46 (parse_parfile) and defers interpretation to
the parameter objects; we do the same split: this module produces a typed,
order-preserving multidict (`ParFile`), and `pint_tpu_torch.models.builder`
interprets entries against component parameter declarations.

Values are kept as strings here: precision-critical fields (epochs, F0) must
not round-trip through float64 before the two-double split happens
(io/tim.py mjd_string_to_day_frac).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable

__all__ = ["ParLine", "ParFile", "parse_parfile", "parse_fit_flag"]


@dataclass
class ParLine:
    """One parfile entry, tokenized."""

    name: str  # upper-cased key, e.g. "F0", "JUMP"
    tokens: list[str]  # everything after the key
    raw: str = ""

    @property
    def value(self) -> str:
        return self.tokens[0] if self.tokens else ""


# Keys that may legally repeat with independent meanings.
REPEATABLE = {
    "JUMP",
    "DMJUMP",
    "EFAC",
    "EQUAD",
    "ECORR",
    "DMEFAC",
    "DMEQUAD",
    "T2EFAC",
    "T2EQUAD",
    "TNECORR",
    "SWIGNORE",
}

_COMMENT_RE = re.compile(r"#.*$")


@dataclass
class ParFile:
    """Order-preserving parfile contents: name -> list of ParLine."""

    entries: dict[str, list[ParLine]] = field(default_factory=dict)
    order: list[ParLine] = field(default_factory=list)
    comments: list[str] = field(default_factory=list)

    def add(self, line: ParLine) -> None:
        self.entries.setdefault(line.name, []).append(line)
        self.order.append(line)

    def get(self, name: str, default: str | None = None) -> str | None:
        ls = self.entries.get(name.upper())
        return ls[0].value if ls else default

    def get_all(self, name: str) -> list[ParLine]:
        return self.entries.get(name.upper(), [])

    def __contains__(self, name: str) -> bool:
        return name.upper() in self.entries

    def names(self) -> Iterable[str]:
        return self.entries.keys()


def parse_parfile(path_or_text: str, from_text: bool = False) -> ParFile:
    """Parse a parfile from a path (or raw text when from_text=True)."""
    if from_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    pf = ParFile()
    for raw in text.splitlines():
        if raw.lstrip().startswith("#"):
            # full-line comments (incl. provenance headers,
            # utils/provenance.py) are retained but never interpreted
            pf.comments.append(raw)
            continue
        line = _COMMENT_RE.sub("", raw).strip()
        if not line:
            continue
        if line.startswith(("C ", "c ")):  # tempo comment convention
            pf.comments.append(raw)
            continue
        parts = line.split()
        name = parts[0].upper()
        pf.add(ParLine(name=name, tokens=parts[1:], raw=raw))
    return pf


def parse_fit_flag(tokens: list[str], value_index: int = 0) -> tuple[bool, str | None]:
    """Interpret the optional ``fit-flag [uncertainty]`` tail after a value.

    Returns (frozen, uncertainty-string). A bare value means frozen; flag 1
    means fitted; flag 0 frozen. Tempo2 sometimes writes
    ``NAME value uncertainty`` with no flag: a non-{0,1} second token is then
    an uncertainty (matches reference parameter.py from_parfile_line logic).
    """
    tail = tokens[value_index + 1 :]
    if not tail:
        return True, None
    if tail[0] in ("0", "1"):
        frozen = tail[0] == "0"
        unc = tail[1] if len(tail) > 1 else None
        return frozen, unc
    return True, tail[0]
