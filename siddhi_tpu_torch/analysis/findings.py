"""Finding/severity model for the static analyzers.

A Finding anchors to ``path:line:col`` (1-based line, 0-based col, the
Python ``ast`` convention) so editors and CI logs can jump straight to
the offending source. The baseline key deliberately excludes the line
number: grandfathered findings must survive unrelated edits above them,
so identity is (rule, path, message) with an occurrence count.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"

SEVERITIES = (ERROR, WARNING)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str        # repo-relative where possible
    line: int        # 1-based
    col: int         # 0-based
    message: str

    @property
    def anchor(self) -> str:
        return f"{self.path}:{self.line}"

    def baseline_key(self) -> str:
        return f"{self.rule}::{self.path}::{self.message}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity} [{self.rule}] {self.message}")
