"""Wire-contract schema: generated .proto files stay in sync and compile.

Reference model: the reference's src/ray/protobuf/*.proto are the
normative contracts; here the dataclasses are normative and the schema is
derived — these tests make drift impossible to miss.

Port of tests/test_proto_schema.py, aimed at ray_tpu_torch.
"""

import shutil
import subprocess
from pathlib import Path

import pytest
from torch_runtime_support import reap_orphans  # noqa: F401

PROTO_DIR = Path(__file__).parent.parent / "ray_tpu_torch" / "protobuf"


def test_generated_protos_current():
    from ray_tpu_torch.protobuf import gen

    assert (PROTO_DIR / "common.proto").read_text() == gen.generate_common()
    assert (PROTO_DIR / "services.proto").read_text() == \
        gen.generate_services()


def test_protos_compile(tmp_path):
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    out = subprocess.run(
        ["protoc", f"--proto_path={PROTO_DIR}",
         f"--python_out={tmp_path}", "common.proto", "services.proto"],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "common_pb2.py").exists()


def test_services_cover_live_rpcs():
    """Every rpc_* handler on every daemon appears in services.proto."""
    import importlib

    from ray_tpu_torch.protobuf.gen import _SERVICES

    text = (PROTO_DIR / "services.proto").read_text()
    for _svc, mod_name, cls_name in _SERVICES:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        for m in vars(cls):
            if m.startswith("rpc_"):
                camel = "".join(p.capitalize()
                                for p in m[len("rpc_"):].split("_"))
                assert f"rpc {camel}(Frame)" in text, m


def test_taskspec_fields_in_schema():
    """TaskSpec message mirrors the dataclass field-for-field, in order
    (field numbers are declaration-ordered, so renumbering = drift)."""
    import dataclasses

    from ray_tpu_torch.core.common import TaskSpec

    text = (PROTO_DIR / "common.proto").read_text()
    block = text.split("message TaskSpec {")[1].split("}")[0]
    for n, f in enumerate(dataclasses.fields(TaskSpec), start=1):
        assert f" {f.name} = {n};" in block, f.name
