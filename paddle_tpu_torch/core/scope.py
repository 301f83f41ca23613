"""Runtime variable store: a scope maps names to torch tensors (on the
executor's device) or host objects such as the random generator.  Child
scopes fall through to their parent on lookup."""
from __future__ import annotations

from typing import Any, Dict, Optional


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def set_var(self, name: str, value):
        self._vars[name] = value

    def update_var(self, name: str, value):
        """Set in whichever ancestor holds the var; else set locally."""
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
