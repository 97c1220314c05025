"""Row-based CSV builder (equivalent of ``include/csvwriter.h:8-153``):
stream values into rows, write with truncate or append.

Copy of ``pplp_tpu.utils.csvwriter``: the same strings and files."""

from __future__ import annotations

__all__ = ["CSVWriter"]


class CSVWriter:
    def __init__(self, separator: str = ","):
        self.separator = separator
        self.rows: list[list[str]] = []

    def new_row(self) -> "CSVWriter":
        self.rows.append([])
        return self

    # Reference exposes operator<<; << chaining maps to .add().
    def add(self, value) -> "CSVWriter":
        if not self.rows:
            self.new_row()
        s = str(value)
        if any(c in s for c in (self.separator, '"', "\n")):
            s = '"' + s.replace('"', '""') + '"'
        self.rows[-1].append(s)
        return self

    def add_all(self, *values) -> "CSVWriter":
        for v in values:
            self.add(v)
        return self

    def to_string(self) -> str:
        return "\n".join(self.separator.join(r) for r in self.rows)

    def write_to_file(self, filename: str, append: bool = False):
        mode = "a" if append else "w"
        with open(filename, mode) as f:
            text = self.to_string()
            if text:
                f.write(text + "\n")
