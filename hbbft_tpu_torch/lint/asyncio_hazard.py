"""Checker: asyncio hazards in the net/obs layers.

The event loop IS the Step pump: anything that silently drops a coroutine,
loses a task, or blocks the loop stalls consensus for the whole node.

- ``async-unawaited-coroutine`` — a call to an ``async def`` defined in the
  same module, used as a bare expression statement: the coroutine object is
  created and garbage-collected without ever running ("coroutine was never
  awaited" at best, a silently missing side effect at worst).
- ``async-fire-and-forget-task`` — ``asyncio.create_task`` /
  ``ensure_future`` whose result is discarded.  The event loop keeps only
  a weak reference to tasks: a fire-and-forget task can be
  garbage-collected mid-flight and its exceptions are never observed.
  Retain the handle (attribute, list, set) or await it.
- ``async-blocking-call`` — a blocking call inside ``async def``:
  ``time.sleep``, synchronous socket/subprocess/urllib calls, ``open()``,
  and the BLS pairing entry points (``pairing``/``pairing_check`` — a
  multi-ms pure-Python computation).  Each blocks every peer's pump, not
  just the caller's.
- ``async-lock-across-await`` — an ``async with <lock>`` (or ``with
  <lock>``) whose body awaits network I/O (``drain``, ``read*``,
  ``open_connection``, ``wait_for`` around those …).  A peer that stops
  reading wedges the awaiting task *while it holds the lock*, starving
  every other task that needs it — the deadlock shape the transport's
  heartbeat logic documents.  ``net/statesync.py`` is in scope like the
  rest of ``net/``: a snapshot transfer awaiting a stalled donor must
  never hold a lock (the client is written lock-free — sequential
  request/response with per-request deadlines — and this rule keeps it
  that way).
- ``pump-inline-crypto`` — a direct ``pairing*`` / share-verify /
  share-generation call in the scheduler module (``net/scheduler.py``).
  The pump's contract is that ALL threshold crypto flows through the
  protocols' deferred-resolution surface and ``crypto/batch.py``'s
  batched executor path; a direct call in the scheduler bypasses the
  cross-epoch batching (and, on the event-loop side, blocks the loop).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from hbbft_tpu_torch.lint.core import Checker, Finding, ModuleSource, register

_TASK_SPAWNERS = {"create_task", "ensure_future"}

#: (module-ish prefix, attr) pairs and bare names that block the loop
_BLOCKING_ATTRS = {
    ("time", "sleep"),
    ("socket", "create_connection"), ("socket", "socket"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "check_call"), ("subprocess", "check_output"),
    ("request", "urlopen"), ("urllib", "urlopen"),
    ("bls", "pairing"), ("bls", "pairing_check"),
}
_BLOCKING_NAMES = {"open", "pairing", "pairing_check", "http_get"}

_NET_IO_ATTRS = {
    "drain", "read", "readline", "readuntil", "readexactly",
    "open_connection", "sendall", "recv", "connect", "accept",
    "wait_closed", "start_server",
}

#: call names that ARE threshold crypto — banned outright in the
#: scheduler module (see the ``pump-inline-crypto`` rule)
_PUMP_CRYPTO_NAMES = {
    "pairing", "pairing_check", "miller_loop",
    "verify", "verify_signature", "verify_signature_share",
    "verify_decryption_share", "batch_verify_sig_shares",
    "batch_verify_dec_shares", "verify_dec_share_sets",
    "verify_ciphertext_batch", "decrypt_share", "decrypt",
    "combine_signatures", "sign", "encrypt",
}

def _is_pump_module(path: str) -> bool:
    """The pump-inline-crypto rule's scope: scheduler modules of the net
    layer (``hbbft_tpu_torch/net/scheduler.py`` and any sibling scheduler)."""
    base = path.rsplit("/", 1)[-1]
    return "/net/" in f"/{path}" and "scheduler" in base


def _lock_like(expr: ast.AST) -> Optional[str]:
    """Name of a lock-ish context expression (``*lock*``/``*sem*``)."""
    name = None
    if isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Call):
        return _lock_like(expr.func)  # e.g. self._lock() factories
    if name is not None:
        low = name.lower()
        if "lock" in low or "semaphore" in low or low.endswith("sem"):
            return name
    return None


def _awaited_net_io(await_node: ast.Await) -> Optional[str]:
    """The network-I/O call name under an ``await``, unwrapping
    ``asyncio.wait_for(...)``; None if the await is not network I/O."""
    value = await_node.value
    if isinstance(value, ast.Call):
        func = value.func
        if isinstance(func, ast.Attribute) and func.attr == "wait_for":
            if value.args and isinstance(value.args[0], ast.Call):
                value = value.args[0]
                func = value.func
        if isinstance(func, ast.Attribute) and func.attr in _NET_IO_ATTRS:
            return func.attr
        if isinstance(func, ast.Name) and func.id in _NET_IO_ATTRS:
            return func.id
    return None


def _collect_async_defs(tree: ast.AST) -> Set[str]:
    return {
        n.name for n in ast.walk(tree)
        if isinstance(n, ast.AsyncFunctionDef)
    }


@register
class AsyncioHazardChecker(Checker):
    name = "asyncio-hazard"
    scope = ("hbbft_tpu_torch/net/", "hbbft_tpu_torch/obs/")
    rules = {
        "async-unawaited-coroutine":
            "coroutine call used as a bare statement — never awaited, "
            "never runs",
        "async-fire-and-forget-task":
            "create_task/ensure_future result discarded — the loop holds "
            "only a weak ref, the GC can cancel the task mid-flight",
        "async-blocking-call":
            "blocking call (time.sleep, sync I/O, subprocess, BLS "
            "pairing) inside async def — stalls the whole Step pump",
        "async-lock-across-await":
            "lock held across an await of network I/O — a stalled peer "
            "wedges every task contending for the lock",
        "pump-inline-crypto":
            "direct pairing/share-crypto call in the scheduler module — "
            "threshold crypto must flow through the protocols' deferred "
            "resolution and crypto/batch.py's batched executor path",
    }

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        tree = mod.tree
        if tree is None:
            return []
        out: List[Finding] = []
        async_defs = _collect_async_defs(tree)
        pump_module = _is_pump_module(mod.path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Expr) and isinstance(
                node.value, ast.Call
            ):
                self._check_bare_call(mod, node.value, async_defs, out)
            if isinstance(node, ast.AsyncFunctionDef):
                self._check_async_body(mod, node, out)
            if isinstance(node, (ast.AsyncWith, ast.With)):
                self._check_lock_span(mod, node, out)
            if pump_module and isinstance(node, ast.Call):
                self._check_pump_crypto(mod, node, out)
        return out

    # -- direct crypto calls in the scheduler -------------------------------

    def _check_pump_crypto(self, mod, call: ast.Call, out) -> None:
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
        if name in _PUMP_CRYPTO_NAMES:
            out.append(self.finding(
                mod, "pump-inline-crypto", call,
                f"{name}() called directly in the scheduler: route it "
                f"through the protocols' resolve_deferred surface / "
                f"crypto.batch so it joins the per-iteration batched "
                f"call (and never runs on the event loop)",
            ))

    # -- bare expression statements ----------------------------------------

    def _check_bare_call(self, mod, call, async_defs, out) -> None:
        func = call.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
            # only `self.<m>()` / `asyncio.<m>()` resolve against this
            # module's async defs: `self._writer.close()` must not match
            # our own `async def close`
            if name not in _TASK_SPAWNERS and not (
                isinstance(func.value, ast.Name)
                and func.value.id in ("self", "asyncio")
            ):
                return
        if name in _TASK_SPAWNERS:
            out.append(self.finding(
                mod, "async-fire-and-forget-task", call,
                f"{name}(...) result discarded: retain the Task (the "
                f"event loop keeps only a weak reference) or await it",
            ))
        elif name in async_defs:
            out.append(self.finding(
                mod, "async-unawaited-coroutine", call,
                f"{name}(...) is a coroutine call used as a statement: "
                f"it never runs without an await (or a retained task)",
            ))

    # -- blocking calls inside async defs ----------------------------------

    def _check_async_body(self, mod, fn: ast.AsyncFunctionDef, out) -> None:
        for node in self._walk_same_function(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = None
            if isinstance(func, ast.Attribute):
                base = func.value
                base_name = (
                    base.id if isinstance(base, ast.Name)
                    else base.attr if isinstance(base, ast.Attribute)
                    else None
                )
                if (base_name, func.attr) in _BLOCKING_ATTRS:
                    hit = f"{base_name}.{func.attr}"
            elif isinstance(func, ast.Name) and func.id in _BLOCKING_NAMES:
                hit = func.id
            if hit is not None:
                out.append(self.finding(
                    mod, "async-blocking-call", node,
                    f"blocking call {hit}() inside async def "
                    f"{fn.name}: it stalls the event loop (use the "
                    f"async equivalent or an executor)",
                ))

    @staticmethod
    def _walk_same_function(fn):
        """All nodes of ``fn`` without descending into nested defs."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- locks held across network awaits ----------------------------------

    def _check_lock_span(self, mod, node, out) -> None:
        lock_name = None
        for item in node.items:
            lock_name = _lock_like(item.context_expr) or lock_name
        if lock_name is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Await):
                io_name = _awaited_net_io(sub)
                if io_name is not None:
                    out.append(self.finding(
                        mod, "async-lock-across-await", node,
                        f"{lock_name} held across await {io_name}(): a "
                        f"peer that stops reading parks this task inside "
                        f"the critical section and starves other "
                        f"contenders",
                    ))
                    return
