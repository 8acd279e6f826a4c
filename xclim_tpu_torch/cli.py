"""Command-line interface (reference: xclim:src/xclim/cli.py, 497 LoC).

Every registered indicator is a dynamic click subcommand; commands chain and
merge their outputs into one output NetCDF::

    python -m xclim_tpu_torch.cli -i in.nc -o out.nc \\
        icclim.TG --freq YS icclim.SU dataflags

The work runs on ``--device`` (default: the current CUDA device; without
one it raises, as :func:`xclim_tpu_torch.default_device` does: pass
``--device cpu`` to run on the CPU). ``--fused`` runs the chain through
:func:`xclim_tpu_torch.climjit_chain`, which is eager in this package.

The pipeline (resolve, open, call, ``--fused``, merge, the data flags,
write) lives in :class:`Pipeline` and :func:`get_indicator`, which need no
click: click is imported only where the command group is built
(:func:`make_cli`; ``xclim_tpu_torch.cli.cli`` builds it on first use).
"""

from __future__ import annotations

import numpy as np

import xclim_tpu_torch
from xclim_tpu_torch.core.dataarray import ClimDataset
from xclim_tpu_torch.core.indicator import InputKind, registry

__all__ = ["NoInputError", "Pipeline", "get_indicator", "make_cli",
           "parse_value"]


class NoInputError(ValueError):
    """A command needs the input dataset and no ``-i`` was given."""


def get_indicator(name: str):
    """Resolve a registry entry; dotted names address virtual modules
    (``icclim.SU``), matching the reference (xclim:cli.py:42-51). Raises
    KeyError for an unknown name."""
    if "." in name:
        mod, ident = name.split(".", 1)
        key = f"{mod}.{ident.upper()}"
    else:
        key = name.upper()
    # the registry fills in when the indicator modules are imported
    import xclim_tpu_torch.indicators  # noqa: F401

    try:
        return registry[key]
    except KeyError as err:
        raise KeyError(f"Indicator '{name}' not found in xclim_tpu_torch.") from err


def parse_value(v):
    """A command-line value as int, else float, else the string."""
    if isinstance(v, str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


class Pipeline:
    """One invocation of the command line: its options, the dataset it
    reads (opened on first use), the calls a ``--fused`` chain defers and
    the merged outputs (xclim:cli.py:90-118, :363-389, :486).

    ``shard`` is stored and read by nothing, as in the reference
    (xclim_tpu/cli.py:245)."""

    def __init__(self, input=None, output=None, shard: bool = False,  # noqa: A002
                 fused: bool = False, device=None):
        self.input = input
        self.output = output
        self.shard = shard
        self.fused = fused
        self.device = device
        self.ds_in: ClimDataset | None = None
        self.ds_out: ClimDataset | None = None
        self.pending: list = []

    def dataset(self) -> ClimDataset:
        """The input dataset on the pipeline's device, opened once."""
        if self.ds_in is None:
            if not self.input:
                raise NoInputError("No input file provided (-i).")
            from xclim_tpu_torch.io import open_dataset

            self.ds_in = open_dataset(self.input, device=self.device)
        return self.ds_in

    def _merge(self, outs):
        ds_out = self.ds_out if self.ds_out is not None else ClimDataset()
        for o in outs:
            ds_out[o.name] = o
        self.ds_out = ds_out

    def indicator(self, ind, **kwargs) -> None:
        """Call an indicator on the input (or, with ``fused``, defer it to
        :meth:`run_fused`) and merge its outputs."""
        ds = self.dataset()
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if self.fused:
            self.pending.append((ind, kwargs))
            return
        out = ind(ds=ds, **kwargs)
        self._merge(out if isinstance(out, tuple) else (out,))

    def run_fused(self) -> None:
        """Run every deferred indicator of a ``--fused`` chain as one
        :func:`~xclim_tpu_torch.climjit_chain` and merge the outputs."""
        if not self.pending:
            return
        ds = self.dataset()

        def make_step(ind, kwargs):
            def step(d):
                return ind(ds=d, **kwargs)
            return step

        steps = [make_step(ind, kwargs) for ind, kwargs in self.pending]
        self.pending = []
        self._merge(xclim_tpu_torch.climjit_chain(steps)(ds))

    def dataflags(self, variables=(), raise_flags: bool = False) -> list[str]:
        """The data flags of the input's variables (all by default). As in
        the reference, they become the output dataset, in place of what
        earlier commands merged (xclim_tpu/cli.py:173). Returns the
        lines the command prints."""
        from xclim_tpu_torch.core.dataflags import data_flags

        ds = self.dataset()
        names = variables or list(ds.keys())
        out = ClimDataset()
        lines = []
        for name in names:
            flags = data_flags(ds[name], ds, raise_flags=raise_flags)
            for k, v in flags.items():
                if v is None:
                    # comparison check whose companion variable is absent
                    lines.append(f"{name}_{k}: None")
                    continue
                out[f"{name}_{k}"] = v
        self.ds_out = out
        lines.extend(f"{k}: {bool(np.asarray(v.values).any())}"
                     for k, v in out.items())
        return lines

    def finish(self) -> ClimDataset | None:
        """Run the deferred chain and write the merged outputs to
        ``output`` (netCDF4; needs h5py) when one is given. Returns them."""
        self.run_fused()
        if self.output and self.ds_out is not None:
            from xclim_tpu_torch.io import to_netcdf

            to_netcdf(self.ds_out, self.output)
        return self.ds_out


def make_cli():
    """The click command group of the command line (imports click)."""
    import click

    def _get(name):
        try:
            return get_indicator(name)
        except KeyError as err:
            raise click.BadArgumentUsage(err.args[0]) from err

    def _pipeline(ctx) -> Pipeline:
        return ctx.obj["pipeline"]

    def _call(fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except NoInputError as err:
            raise click.UsageError(str(err)) from err

    def _create_command(name: str):
        """Build a click command from an indicator's parameters
        (xclim:cli.py:120)."""
        ind = _get(name)
        params = []
        for pname, p in ind.parameters.items():
            if p.injected or pname in ind._variables or p.kind == InputKind.KWARGS:
                continue
            params.append(click.Option(
                [f"--{pname}"], default=None, show_default=False,
                help=p.description or f"Parameter {pname}"))
        for vname in ind._variables:
            params.append(click.Option(
                [f"--{vname}"], default=None,
                help=f"Name of the variable in the dataset for {vname}."))

        @click.pass_context
        def _run(ctx, **kwargs):
            clean = {k: parse_value(v) for k, v in kwargs.items()
                     if v is not None}
            _call(_pipeline(ctx).indicator, ind, **clean)

        return click.Command(name, params=params, callback=_run,
                             help=(ind.title or name) + "\n\n" + (ind.abstract or ""))

    @click.command(short_help="List indicators.")
    @click.pass_context
    def indices(ctx):
        """List all indicators (xclim:cli.py:187)."""
        import xclim_tpu_torch.indicators  # noqa: F401

        for key, ind in sorted(registry.items()):
            click.echo(f"{key.lower()} : {ind.title}")

    @click.command(short_help="Indicator information.")
    @click.argument("indicator", nargs=-1)
    @click.pass_context
    def info(ctx, indicator):
        """Print information about indicators (xclim:cli.py:210)."""
        import json

        for name in indicator:
            click.echo(json.dumps(_get(name).json(), indent=2, default=str))

    @click.command(short_help="Run data quality checks.")
    @click.option("-v", "--variables", multiple=True, help="Variables to check.")
    @click.option("-r", "--raise-flags", is_flag=True, help="Raise on failures.")
    @click.pass_context
    def dataflags(ctx, variables, raise_flags):
        """Run data flag checks on the input (xclim:cli.py:240)."""
        for line in _call(_pipeline(ctx).dataflags, variables, raise_flags):
            click.echo(line)

    @click.command(short_help="Print versions.")
    @click.pass_context
    def show_version_info(ctx):
        """Print versions of xclim_tpu_torch and its dependencies
        (xclim:cli.py:330)."""
        import torch

        devices = [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
        click.echo(f"xclim_tpu_torch: {xclim_tpu_torch.__version__}")
        click.echo(f"torch: {torch.__version__}")
        click.echo(f"cuda: {torch.version.cuda}")
        click.echo(f"numpy: {np.__version__}")
        click.echo(f"devices: {devices or ['cpu']}")

    @click.command(short_help="Print the changelog.")
    @click.option("-m", "--md", is_flag=True, help="Markdown formatting.")
    @click.pass_context
    def release_notes(ctx, md):
        """Print the package changelog (xclim:cli.py:300)."""
        from pathlib import Path

        changelog = Path(__file__).parent.parent / "CHANGELOG.md"
        if changelog.exists():
            click.echo(changelog.read_text())
        else:
            click.echo(f"xclim_tpu_torch {xclim_tpu_torch.__version__} — "
                       "no changelog found.")

    @click.command(short_help="Prefetch testing data.")
    @click.pass_context
    def prefetch_testing_data(ctx):
        """Download testing data (xclim:cli.py:270). This package generates
        its test data synthetically (xclim_tpu_torch.testing.helpers):
        nothing to fetch."""
        click.echo("xclim_tpu_torch generates test data synthetically; "
                   "nothing to fetch.")

    static = {
        "indices": indices,
        "info": info,
        "dataflags": dataflags,
        "prefetch_testing_data": prefetch_testing_data,
        "release_notes": release_notes,
        "show_version_info": show_version_info,
    }

    class XclimCli(click.Group):
        """Dynamic group resolving indicator names to commands
        (xclim:cli.py:363)."""

        def list_commands(self, ctx):
            import xclim_tpu_torch.indicators  # noqa: F401

            return list(static) + sorted(k.lower() for k in registry)

        def get_command(self, ctx, name):
            if name in static:
                return static[name]
            return _create_command(name)

    @click.command(cls=XclimCli, chain=True)
    @click.option("-i", "--input", help="Input NetCDF file.")
    @click.option("-o", "--output", help="Output NetCDF file.")
    @click.option("--shard/--no-shard", default=False,
                  help="Shard the spatial grid over the local devices "
                       "(stored, not read, as in the reference).")
    @click.option("--fused/--no-fused", default=False,
                  help="Run the whole indicator chain as one climjit_chain.")
    @click.option("--device", default=None,
                  help="Torch device of the computation (default: the "
                       "current CUDA device; 'cpu' for the CPU).")
    @click.pass_context
    def cli(ctx, input, output, shard, fused, device):  # noqa: A002
        """Command-line interface of xclim_tpu_torch (xclim:cli.py:430)."""
        ctx.obj = {"pipeline": Pipeline(input, output, shard, fused, device)}

    @cli.result_callback()
    @click.pass_context
    def write_file(ctx, results, input, output, shard, fused, device):  # noqa: A002
        """Write the merged output dataset (xclim:cli.py:486)."""
        pipe = _pipeline(ctx)
        pipe.run_fused()
        if output and pipe.ds_out is not None:
            click.echo(f"Writing to file {output}")
        pipe.finish()

    return cli


def __getattr__(name):
    if name == "cli":
        globals()["cli"] = make_cli()
        return globals()["cli"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if __name__ == "__main__":
    make_cli()()
