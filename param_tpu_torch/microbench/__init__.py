"""Config-driven operator micro-benchmark framework.

Port of ``param_tpu/microbench``, counterpart of the reference's
``train/compute/python`` package:
an operator registry, JSON benchmark configs with ``__range__``/``__copy__``
macro expansion, pluggable data generators, and executors producing
JSON-lines results.  Reference layer map in SURVEY.md §2.3.
"""

from param_tpu_torch.microbench.generator import (  # noqa: F401
    IterableList,
    ListProduct,
    TableProduct,
    full_range,
)
from param_tpu_torch.microbench.iterator import (  # noqa: F401
    ConfigIterator,
    DefaultConfigIterator,
    RangeConfigIterator,
    register_config_iterator,
)
from param_tpu_torch.microbench.operator import (  # noqa: F401
    OperatorInterface,
    get_operator,
    op_map,
    register_operator,
    register_operators,
)
from param_tpu_torch.microbench.data import (  # noqa: F401
    DataGenerator,
    DefaultDataGenerator,
    register_data_generator,
)
