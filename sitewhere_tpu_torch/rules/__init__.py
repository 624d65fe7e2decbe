"""Bring-your-own-rules: per-tenant rule and enrichment programs, bucketed
into a bounded set of batched passes.  Counterpart of
``sitewhere_tpu/rules``, its mesh half (``compile.sharded_prepare``)
included.

- ``dsl``       declarative program documents, validation, canonical form,
                and the structure key that buckets programs;
- ``interp``    slow numpy reference interpreter (golden semantics);
- ``compile``   the torch prepare and group-eval passes, one group pass
                per structure key, constants lifted into operand tables;
- ``registry``  per-tenant store with epoch-published operand tables;
- ``enrich``    device and asset attribute tables for metadata joins;
- ``engine``    the lifecycle runner wired into the dispatcher.
"""

from sitewhere_tpu_torch.rules.dsl import (  # noqa: F401
    RuleProgramError,
    parse_program,
    structure_key,
)
from sitewhere_tpu_torch.rules.engine import RuleEngineRunner  # noqa: F401
from sitewhere_tpu_torch.rules.enrich import AttributeStore  # noqa: F401
from sitewhere_tpu_torch.rules.registry import ProgramRegistry  # noqa: F401

__all__ = [
    "RuleProgramError",
    "parse_program",
    "structure_key",
    "RuleEngineRunner",
    "AttributeStore",
    "ProgramRegistry",
]
