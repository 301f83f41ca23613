"""Deterministic, seedable fault injection, copied from the JAX package's
``faults`` module (stdlib only): the same spec grammar, the same crc32
seeding and the same site catalogue, so one spec and seed fire identically
in both packages, hit for hit.

Production code declares *injection sites* -- named points where a fault
MAY happen -- by calling :func:`fire`:

    from paddle_tpu_torch import faults
    ...
    faults.fire("serving.backend")            # may SIGKILL / delay / raise
    if faults.fire("dispatch.renew"):         # True -> caller drops the op
        return

With no plan installed (the default), ``fire`` is one global load and a
``None`` check.  A plan comes from the environment (``PADDLE_TPU_FAULTS``
+ ``PADDLE_TPU_FAULTS_SEED``, read once at import) or from
:func:`install`.  In the port, ``ServingSession(fault_site=)`` fires
``serving.backend`` and its own site for every dispatched batch.

Spec grammar (``;``-separated entries)::

    PADDLE_TPU_FAULTS = entry[;entry...]
    entry  = action@site[:k=v[,k=v...]]
    action = kill   - SIGKILL this process
           | fail   - raise FaultInjected at the site
           | drop   - fire() returns True; the caller skips the operation
           | delay  - sleep s= seconds at the site ("stall" is an alias)
    params = n=<int>    fire only on the Nth hit of the site (1-based)
           | p=<float>  fire with probability p per hit (seeded RNG)
           | s=<float>  sleep seconds (delay/stall)

Examples::

    kill@dispatch.task_start:n=3          # die starting the 3rd task
    drop@dispatch.renew:p=0.5             # lose half the lease renewals
    fail@serving.backend.m:n=2            # model m's second batch raises
    delay@serving.runner:s=0.03,p=0.3     # slow 30% of serving batches

Determinism: each injection owns a ``random.Random`` seeded from
``(global seed, site, injection index)`` via crc32 -- two processes with
the same spec + seed fire identically, and the per-site hit counters are
exact, so ``n=``-gated faults are reproducible to the call.
"""
from __future__ import annotations

import os
import signal
import time
import zlib
from typing import Any, Dict, List, Optional

__all__ = ["FaultInjected", "FaultPlan", "fire", "install", "reset",
           "active", "counters", "fired_log", "register_site", "sites"]

ENV_SPEC = "PADDLE_TPU_FAULTS"
ENV_SEED = "PADDLE_TPU_FAULTS_SEED"

_ACTIONS = ("kill", "fail", "drop", "delay", "stall")


class FaultInjected(RuntimeError):
    """Raised by a ``fail@site`` injection — the structured chaos error a
    robust caller is expected to survive (retry, requeue, lease-expire)."""

    def __init__(self, site: str):
        super().__init__(f"fault injected at site {site!r}")
        self.site = site


class _Injection:
    __slots__ = ("action", "site", "n", "p", "s", "index", "hits",
                 "fires", "_rng")

    def __init__(self, action: str, site: str, index: int,
                 n: Optional[int] = None, p: Optional[float] = None,
                 s: float = 0.0, seed: int = 0):
        self.action = "delay" if action == "stall" else action
        self.site = site
        self.index = index
        self.n = n
        self.p = p
        self.s = float(s)
        self.hits = 0
        self.fires = 0
        # per-injection seeded stream: stable across processes for a fixed
        # (seed, site, index) — crc32 keeps it independent of PYTHONHASHSEED
        import random
        self._rng = random.Random(
            (int(seed) << 32) ^ zlib.crc32(f"{site}#{index}".encode()))

    def should_fire(self) -> bool:
        self.hits += 1
        if self.n is not None and self.hits != self.n:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        self.fires += 1
        return True


class FaultPlan:
    """A parsed spec: injections grouped by site, plus the fired log the
    determinism tests replay."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.by_site: Dict[str, List[_Injection]] = {}
        self.log: List[tuple] = []        # (site, action, hit#)
        idx = 0
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            head, _, params = entry.partition(":")
            action, at, site = head.partition("@")
            action = action.strip().lower()
            site = site.strip()
            if not at or not site or action not in _ACTIONS:
                raise ValueError(
                    f"bad fault entry {entry!r}: want action@site[:k=v,...] "
                    f"with action in {_ACTIONS}")
            kw: Dict[str, Any] = {}
            for kv in filter(None, (p.strip() for p in params.split(","))):
                k, _, v = kv.partition("=")
                if k == "n":
                    kw["n"] = int(v)
                elif k == "p":
                    kw["p"] = float(v)
                elif k == "s":
                    kw["s"] = float(v)
                else:
                    raise ValueError(f"bad fault param {kv!r} in {entry!r}")
            inj = _Injection(action, site, idx, seed=self.seed, **kw)
            self.by_site.setdefault(site, []).append(inj)
            idx += 1

    def fire(self, site: str) -> bool:
        injections = self.by_site.get(site)
        if not injections:
            return False
        dropped = False
        for inj in injections:
            if not inj.should_fire():
                continue
            self.log.append((site, inj.action, inj.hits))
            if inj.action == "kill":
                # the hard death: no atexit, no stream flush — what the
                # lease/timeout machinery exists to survive
                os.kill(os.getpid(), signal.SIGKILL)
            elif inj.action == "fail":
                raise FaultInjected(site)
            elif inj.action == "drop":
                dropped = True
            elif inj.action == "delay":
                time.sleep(inj.s)
        return dropped

    def counters(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for site, injections in self.by_site.items():
            hits = sum(i.hits for i in injections)
            fires = sum(i.fires for i in injections)
            out[site] = {"hits": hits, "fires": fires}
        return out


#: the installed plan; None (the common case) makes fire() a no-op
PLAN: Optional[FaultPlan] = None

#: the site registry: every ``register_site`` declaration, name -> doc.
#: Purely descriptive — ``fire`` works on unregistered names too — but a
#: registered site is discoverable (``sites()``), so chaos specs can be
#: written against the catalogue instead of grepping for fire() calls.
_SITES: Dict[str, str] = {}


def register_site(name: str, doc: str = "") -> str:
    """Declare an injection site (idempotent; typically at import time of
    the module that fires it).  Registration changes nothing about the
    inert path — ``fire`` on a registered site with no plan installed is
    still one global load — it only makes the site show up in
    :func:`sites` with its one-line description.  Returns ``name`` so a
    module can bind it: ``SITE_X = faults.register_site("x", "...")``."""
    if not name or "@" in name or ";" in name:
        raise ValueError(f"bad fault site name {name!r}")
    if doc or name not in _SITES:
        _SITES[name] = doc
    return name


def sites() -> Dict[str, str]:
    """The registered injection-site catalogue ({name: doc})."""
    return dict(_SITES)


# the core sites the dispatch/serving layers fire, registered here so the
# catalogue is complete even before those modules import
for _name, _doc in (
        ("dispatch.task_start", "before consuming each leased task "
                                "(kill = the chaos worker death)"),
        ("dispatch.renew", "each lease heartbeat (drop/delay model lost "
                           "or slow renewals)"),
        ("dispatch.finish", "each task_finished callback (fail = a lost "
                            "retirement; the lease expires and re-serves)"),
        ("dispatch.read", "each yielded sample (delay = slow-reader "
                          "stall)"),
        ("serving.runner", "each dispatched serving batch (delay = the "
                           "soak's slow-runner stall)"),
):
    register_site(_name, _doc)
del _name, _doc


def fire(site: str) -> bool:
    """Hit an injection site.  Returns True when a ``drop`` injection
    fired (the caller skips the guarded operation); may sleep, raise
    :class:`FaultInjected`, or SIGKILL the process per the plan.  With no
    plan installed this is a single global load — the inert path."""
    if PLAN is None:
        return False
    return PLAN.fire(site)


def active() -> bool:
    return PLAN is not None


def install(spec: Optional[str], seed: Optional[int] = None) -> Optional[
        FaultPlan]:
    """Install (or, with a falsy spec, clear) the process fault plan.
    Returns the plan.  Tests and the soak harness call this directly;
    normal processes inherit it from the environment at import."""
    global PLAN
    if not spec:
        PLAN = None
        return None
    if seed is None:
        seed = int(os.environ.get(ENV_SEED, "0") or 0)
    PLAN = FaultPlan(spec, seed=seed)
    return PLAN


def reset():
    """Clear the plan (tests)."""
    install(None)


def counters() -> Dict[str, Dict[str, int]]:
    """Per-site hit/fire counters of the installed plan ({} when inert)."""
    return PLAN.counters() if PLAN is not None else {}


def fired_log() -> List[tuple]:
    """The ordered (site, action, hit#) log of fired injections."""
    return list(PLAN.log) if PLAN is not None else []


# environment-driven activation: one env read at import, zero overhead
# for every process that never sets PADDLE_TPU_FAULTS
install(os.environ.get(ENV_SPEC))
