"""Streamflow indicator declarations
(reference: xclim:src/xclim/indicators/land/_streamflow.py, 241 LoC)."""

from __future__ import annotations

from xclim_tpu_torch import indices
from xclim_tpu_torch.core.indicator import Daily, ReducingIndicator, ResamplingIndicator

__all__ = [
    "base_flow_index_seasonal_ratio",
    "lag_snowpack_flow_peaks",
    "runoff_ratio",
    "sen_slope",
    "base_flow_index",
    "doy_qmax",
    "doy_qmin",
    "flow_index",
    "high_flow_frequency",
    "low_flow_frequency",
    "rb_flashiness_index",
    "standardized_groundwater_index",
    "standardized_streamflow_index",
]


class Streamflow(Daily):
    realm = "land"
    context = "hydro"
    keywords = "streamflow"


base_flow_index = Streamflow(
    identifier="base_flow_index",
    title="Base flow index",
    units="",
    long_name="Base flow index",
    description="Minimum of the 7-day moving average flow divided by the mean "
                "flow.",
    compute=indices.base_flow_index,
)

rb_flashiness_index = Streamflow(
    identifier="rb_flashiness_index",
    title="Richards-Baker flashiness index",
    units="",
    long_name="Richards-Baker flashiness index",
    description="{freq} of Richards-Baker index, indicating the flashiness of "
                "the streamflow.",
    compute=indices.rb_flashiness_index,
)

# the reference builds these on generic.select_resample_op so they accept
# time-indexing kwargs (xclim:indicators/land/_streamflow.py:83-104)
doy_qmax = Streamflow(
    identifier="doy_qmax",
    title="Day of year of the maximum streamflow",
    units="1",
    long_name="Day of the year of the maximum streamflow",
    description="Day of the year of the maximum streamflow over {freq}.",
    compute=indices.generic.select_resample_op,
    parameters={"da": {"kind": 0}, "op": "doymax", "out_units": None},
)

doy_qmin = Streamflow(
    identifier="doy_qmin",
    title="Day of year of the minimum streamflow",
    units="1",
    long_name="Day of the year of the minimum streamflow",
    description="Day of the year of the minimum streamflow over {freq}.",
    compute=indices.generic.select_resample_op,
    parameters={"da": {"kind": 0}, "op": "doymin", "out_units": None},
)

standardized_streamflow_index = Streamflow(
    identifier="ssi",
    title="Standardized streamflow index",
    units="",
    long_name="Standardized streamflow index (SSI)",
    description="Streamflow over a moving {window}-X window, normalized such "
                "that SSI averages to 0 for the calibration data.",
    compute=indices.standardized_streamflow_index,
)

standardized_groundwater_index = Streamflow(
    identifier="sgi",
    title="Standardized groundwater index",
    units="",
    long_name="Standardized groundwater index (SGI)",
    description="Groundwater level over a moving {window}-X window, normalized "
                "such that SGI averages to 0 for the calibration data.",
    compute=indices.standardized_groundwater_index,
)

flow_index = ReducingIndicator(
    identifier="flow_index",
    realm="land",
    title="Flow index",
    units="1",
    long_name="Flow index",
    description="{p}th percentile normalized by the median flow.",
    compute=indices.flow_index,
)

high_flow_frequency = Streamflow(
    identifier="high_flow_frequency",
    title="High flow frequency",
    units="days",
    long_name="High flow frequency",
    description="{freq} frequency of flows greater than {threshold_factor} "
                "times the median flow.",
    compute=indices.high_flow_frequency,
)

low_flow_frequency = Streamflow(
    identifier="low_flow_frequency",
    title="Low flow frequency",
    units="days",
    long_name="Low flow frequency",
    description="{freq} frequency of flows smaller than {threshold_factor} "
                "times the mean flow.",
    compute=indices.low_flow_frequency,
)


base_flow_index_seasonal_ratio = Streamflow(
    identifier="base_flow_index_seasonal_ratio",
    title="Seasonal base flow index and winter/summer ratio",
    cf_attrs=[
        {"var_name": "bfi", "units": "",
         "long_name": "Base flow index per season"},
        {"var_name": "bfi_ratio", "units": "",
         "long_name": "Ratio of {numerator} to {denominator} base flow index"},
    ],
    missing="skip",
    compute=indices.base_flow_index_seasonal_ratio,
)

lag_snowpack_flow_peaks = Streamflow(
    identifier="lag_snowpack_flow_peaks",
    title="Lag between maximum snowpack and river high flows",
    units="days",
    long_name="Days between annual maximum snowpack and the mean date of "
              "high flows",
    description="{freq} number of days between the maximum snow amount and "
                "the mean date of flows exceeding the {p} quantile.",
    missing="skip",
    compute=indices.lag_snowpack_flow_peaks,
)

runoff_ratio = Streamflow(
    identifier="runoff_ratio",
    title="Runoff ratio",
    units="",
    long_name="Ratio of streamflow to precipitation",
    description="{freq} ratio of the accumulated streamflow volume to the "
                "accumulated precipitation over the drainage area.",
    missing="skip",
    compute=indices.runoff_ratio,
)

sen_slope = Streamflow(
    identifier="sen_slope",
    title="Sen slope and Mann-Kendall trend test",
    cf_attrs=[
        {"var_name": "sen_slope", "units": "",
         "long_name": "Theil-Sen slope estimator"},
        {"var_name": "p_value", "units": "",
         "long_name": "Mann-Kendall trend test p-value"},
    ],
    missing="skip",
    compute=indices.sen_slope,
)
