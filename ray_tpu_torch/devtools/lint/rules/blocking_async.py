"""blocking-in-async: synchronous blocking calls inside ``async def``.

One blocking call on the event loop stalls every coroutine sharing it —
the class of bug behind the collective mailbox's "must stay off the
event loop" workaround. Matches exact call chains (``time.sleep``,
``ray_tpu_torch.get``, ``runtime.get`` ...), not any ``.get`` tail, so RPC
client lookups like ``runtime.pool.get(addr)`` don't false-positive.
"""

from __future__ import annotations

import ast

from ray_tpu_torch.devtools.lint.astutil import dotted_name, walk_scope
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

# Exact dotted chains (after stripping a leading ``self.``) that block
# the calling thread. Conservative by design: aliases the analyzer can't
# see stay unflagged rather than spraying false positives.
_BLOCKING = {
    "time.sleep",
    "ray_tpu_torch.get", "ray_tpu_torch.wait",
    "runtime.get", "runtime.wait",
    "rt.get", "rt.wait",
    "_runtime.get", "_runtime.wait",
    "_rt.get", "_rt.wait",
}

_ASYNC_ALTERNATIVE = {
    "time.sleep": "await asyncio.sleep(...)",
}


@register
class BlockingInAsync(Rule):
    id = "blocking-in-async"
    doc = ("blocking call (time.sleep / runtime.get / object-store read) "
           "inside an async def body stalls the whole event loop")
    hint = ("use the async equivalent, or push the blocking call to a "
            "thread with loop.run_in_executor")

    def check(self, parsed):
        for fn in ast.walk(parsed.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in walk_scope(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name.startswith("self."):
                    name = name[len("self."):]
                if name in _BLOCKING:
                    alt = _ASYNC_ALTERNATIVE.get(
                        name, "an awaitable API / run_in_executor")
                    yield Finding(
                        rule=self.id, path=parsed.path,
                        line=node.lineno, col=node.col_offset,
                        message=f"blocking {name}(...) inside async def "
                                f"{fn.name} blocks the event loop",
                        hint=f"replace with {alt}")
