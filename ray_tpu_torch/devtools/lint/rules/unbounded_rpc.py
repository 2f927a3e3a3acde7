"""unbounded-rpc-call: control-plane RPCs opted out of the deadline.

Every ``RpcClient.call`` carries ``rpc_call_timeout_s`` by default
(core/rpc.py sentinel), so the only way to hang forever on a gray peer —
black-holed link, wedged handler — is to pass an explicit
``timeout=None``. That opt-out is legitimate exactly twice in the tree
(task pushes, whose awaits are bounded by connection liveness via the
keepalive, not by a deadline) and each such site must carry a reviewed
``# raylint: disable=unbounded-rpc-call`` justification. Anything else
is a partition hazard: the caller blocks past every failure-detection
bound the health plane has.

Matched shape: a call whose callee attribute is ``call`` or
``start_call`` with an explicit ``timeout=None`` keyword. Methods named
``call`` on non-RPC objects don't pass ``timeout=None`` in this tree;
if one ever does, the suppression comment is the documented escape.
"""

from __future__ import annotations

import ast

from ray_tpu_torch.devtools.lint.astutil import dotted_name
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_RPC_METHODS = {"call", "start_call"}


@register
class UnboundedRpcCall(Rule):
    id = "unbounded-rpc-call"
    doc = ("RPC .call(..., timeout=None) opts out of the default "
           "deadline and can hang forever on a gray (black-holed) peer")
    hint = ("drop timeout=None to inherit rpc_call_timeout_s, pass an "
            "explicit bound, or justify the unbounded await with "
            "# raylint: disable=unbounded-rpc-call")

    def check(self, parsed):
        for node in ast.walk(parsed.tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _RPC_METHODS:
                continue
            for kw in node.keywords:
                if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is None:
                    recv = dotted_name(node.func.value) or "<expr>"
                    yield Finding(
                        rule=self.id, path=parsed.path,
                        line=kw.value.lineno, col=kw.value.col_offset,
                        message=f"{recv}.{node.func.attr}(..., timeout=None) "
                                "is unbounded: a black-holed peer hangs this "
                                "await past every deadline",
                        hint=self.hint)
