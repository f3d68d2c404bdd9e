from .device import resolve_device as resolve_device
from .temperature import (
    alpha_bar_from_log_temp as alpha_bar_from_log_temp,
    bcast_right as bcast_right,
    log_temp_from_alpha_bar as log_temp_from_alpha_bar,
    one_minus_alpha_bar_from_log_temp as one_minus_alpha_bar_from_log_temp,
)
from .interp import interp1d as interp1d
