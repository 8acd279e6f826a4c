from xclim_tpu_torch.io.netcdf import open_dataset, to_netcdf  # noqa: F401
