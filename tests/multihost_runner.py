"""Subprocess entry point for multi-host tests (NOT a test module).

Configures a fresh virtual-CPU backend, optionally joins a jax.distributed
process group on localhost, then invokes the CLI — one spawned process per
"host". This is how the 2-process x 4-device fixture emulates a 2-host
cluster on one machine (SURVEY.md §4 "fake backend" strategy extended
across the process boundary).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--out", default=None, help="summary JSON path (coordinator)")
    ap.add_argument("--then-load", type=int, default=None, metavar="T2",
                    help="after the main run, run the CLI again with --load "
                         "-T T2 in the SAME process group (checkpoint-resume "
                         "coverage without a second spawn: the resumed fit "
                         "hits the in-process jit cache)")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER)
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", a.devices)
    from gparml.utils import compile_cache

    compile_cache.enable()

    if a.process_id is not None:
        from gparml.parallel import distributed

        distributed.initialize(
            coordinator_address=f"localhost:{a.port}",
            num_processes=a.num_processes,
            process_id=a.process_id,
        )

    from gparml import cli

    cli_args = [arg for arg in a.cli_args if arg != "--"]
    summary = cli.main(cli_args)
    if a.then_load is not None:
        # argparse keeps the LAST occurrence of a repeated flag
        summary["resumed"] = cli.main(cli_args + ["--load", "-T", str(a.then_load)])
    if a.out and (a.process_id is None or a.process_id == 0):
        import resource

        # per-host footprint evidence (config-5 dryrun): Linux reports KB
        summary["peak_rss_mb"] = round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1
        )
        with open(a.out, "w") as f:
            json.dump(summary, f)


if __name__ == "__main__":
    main()
