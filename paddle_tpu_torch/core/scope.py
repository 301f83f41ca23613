"""Runtime variable store: a scope maps names to torch tensors (on the
executor's device) or host objects such as the random generator.  Child
scopes fall through to their parent on lookup."""
from __future__ import annotations

import contextlib
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

    def erase(self, name: str):
        """Drop ``name`` from this scope (not its ancestors)."""
        self._vars.pop(name, None)

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


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Make ``scope`` the global scope for the block (Fluid's
    ``executor.scope_guard``): ``io`` and an executor run given no scope
    read and write it."""
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield scope
    finally:
        _global_scope = prev
