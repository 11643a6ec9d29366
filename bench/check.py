"""One compared number beside its limit, and the verdict over them."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    rule: str = "<="  # value <= limit, or ">=" for a floor

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        if self.rule == "<=":
            return self.value <= self.limit
        return self.value >= self.limit

    def line(self) -> str:
        return (f"check {self.name} {self.value!r} limit {self.rule} "
                f"{self.limit!r} {'ok' if self.ok else 'FAIL'}")

    def entry(self) -> dict:
        return {"value": self.value, "limit": self.limit, "rule": self.rule}


def verdict(checks) -> bool:
    return bool(checks) and all(c.ok for c in checks)
