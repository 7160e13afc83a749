"""Host-side utilities of the port (device resolution, native data
generation, dtypes, timers, chip constants)."""

from param_tpu_torch.utils.sizes import (  # noqa: F401
    parse_size,
    format_size,
    size_sweep,
    fix_begin_size,
)
from param_tpu_torch.utils.bw import alg_bw, bus_bw, bus_bw_factor  # noqa: F401
from param_tpu_torch.utils.dtypes import (  # noqa: F401
    DTYPE_MAP,
    dtype_from_name,
    dtype_size,
)
from param_tpu_torch.utils.timer import ParamTimer, param_profile  # noqa: F401
