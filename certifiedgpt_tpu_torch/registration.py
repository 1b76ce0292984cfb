"""Import-time registration of the port's components.

Importing this module registers, in the port's registry
(``common/registry.py``), the processors, dataset builders, model and
agents and lr schedulers that the port has, under the JAX package's
names::

    from certifiedgpt_tpu_torch import registration  # noqa: F401
"""

import certifiedgpt_tpu_torch.data.processors  # noqa: F401
import certifiedgpt_tpu_torch.data.builders  # noqa: F401
import certifiedgpt_tpu_torch.models.model_zoo  # noqa: F401
import certifiedgpt_tpu_torch.agents.certify  # noqa: F401
import certifiedgpt_tpu_torch.agents.eval  # noqa: F401
import certifiedgpt_tpu_torch.agents.finetune  # noqa: F401
import certifiedgpt_tpu_torch.optim  # noqa: F401
