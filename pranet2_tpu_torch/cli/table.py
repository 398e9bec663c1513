"""Plain-text tables for the CLIs (the JAX package prints them with
``tabulate``, which the port does not need)."""

from __future__ import annotations


def format_table(rows, headers, floatfmt: str = ".3f") -> str:
    """``rows`` (lists of cells) under ``headers``, each column as wide as
    its widest cell: floats by ``floatfmt``, numbers right-aligned, text
    left-aligned, ``None`` and "" blank."""
    def cell(v):
        if v is None:
            return ""
        if isinstance(v, float):
            return format(v, floatfmt)
        return str(v)

    text = [[cell(v) for v in r] for r in rows]
    numeric = [all(isinstance(r[i], (int, float)) or r[i] in ("", None)
                   for r in rows) for i in range(len(headers))]
    widths = [max([len(h)] + [len(r[i]) for r in text])
              for i, h in enumerate(headers)]

    def line(cells):
        return "  ".join(c.rjust(w) if num else c.ljust(w)
                         for c, w, num in zip(cells, widths, numeric)).rstrip()

    return "\n".join([line(headers), line(["-" * w for w in widths]),
                      *map(line, text)])
