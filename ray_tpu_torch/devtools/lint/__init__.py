"""raylint — distributed-correctness static analysis for ray_tpu_torch.

Port of ``ray_tpu/devtools/lint`` with the reference's rule IDs, CLI,
JSON schema, suppression syntax and result cache; pure ``ast`` (no
torch, no JAX). The SPMD rules read the port's idioms: DeviceMesh axis
names, ``spmd``/``torch.distributed`` collectives, ``sharded_jit``/
``_shard_map``/``local_map`` specs, and ``torch.cuda.graph`` /
``torch.compile`` regions whose Python runs once.

Run it:            python -m ray_tpu_torch.devtools.lint [paths] [--json]
  (or)             python -m ray_tpu_torch.cli lint [paths] [--json]
Library entry:     run_lint(paths) -> LintReport
Rule catalog:      python -m ray_tpu_torch.devtools.lint --list-rules
Suppress a site:   trailing `# raylint: disable=<rule-id> -- why`

The tier-1 gate (tests/test_torch_lint.py) runs the analyzer over
ray_tpu_torch/ and fails on any unsuppressed finding, so the rule suite
is a ratchet: a pattern added here can never regress back into the tree.
"""

from ray_tpu_torch.devtools.lint.engine import (  # noqa: F401
    LintReport, ParsedFile, collect_files, run_lint)
from ray_tpu_torch.devtools.lint.findings import Finding  # noqa: F401
from ray_tpu_torch.devtools.lint.registry import (  # noqa: F401
    Rule, all_rules, register, rule_ids)
