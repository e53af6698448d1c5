#!/usr/bin/env python3
"""The reference's one-microbatch peak a device of dry-run cells, in GiB:
its ``repro.launch.dryrun.lower_cell`` at one microbatch compiled for 256
forced CPU devices on a (16, 16) ("data", "model") mesh of ``Auto`` axes
(``--xla_cpu_max_isa=AVX``), argument plus temp bytes of
``.compile().memory_analysis()``. The port keeps the single mesh's values
as constants (``repro_torch.launch.dryrun.REFERENCE_PEAK_GIB``).

    PYTHONPATH=src python tests/reference_peaks.py --cells llama3-8b/train_4k ... [--smoke]

A full-size cell takes 1-114 s to compile and gigabytes of host memory;
``--smoke`` compiles the arch's smoke config, 8 sequences of 64 tokens, on
a (2, 2) mesh, to try the script in seconds. Prints one JSON line a cell.
Not a test: it lives beside the tests that compare the port with the
reference, since it imports JAX and the reference (the port does not).
"""

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", required=True, help="ARCH/SHAPE entries")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    shape = (2, 2) if args.smoke else (16, 16)
    n = shape[0] * shape[1]
    # before JAX starts its backend
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                               "--xla_cpu_max_isa=AVX")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.dryrun as dryrun
    from repro.configs import SHAPES, get_config, smoke_config
    from repro.configs.base import ShapeConfig
    from repro.launch.shardings import plan_for

    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    for cell in args.cells:
        arch, name = cell.split("/")
        cfg = smoke_config(arch) if args.smoke else get_config(arch)
        shp = SHAPES[name]
        if args.smoke:
            shp = ShapeConfig(shp.name, 64, 8, shp.kind)
        ma = dryrun.lower_cell(cfg, shp, mesh, plan_for(cfg, mesh)).compile().memory_analysis()
        arg, temp = int(ma.argument_size_in_bytes), int(ma.temp_size_in_bytes)
        print(json.dumps({"cell": cell, "mesh": list(shape), "argument_bytes": arg,
                          "temp_bytes": temp, "peak_gib": (arg + temp) / 2 ** 30}), flush=True)


if __name__ == "__main__":
    main()
