"""One traced run of a cell, as `run.py --trace 1` makes it, then what the
port's own spans add to it (attribution.py:fields) on one more line:

    python3 zkbench/trace_report.py --workload fib-core.prove-n58218 --seed 7 --seconds 51

from the root of a checkout. The first JSON line is run.py's result line;
the last is {"program_s", "device_by_span", "idle_by_span", "attributed"},
or {} where the port has no spans of its own."""

import json
import os
import sys

if not __package__:  # run as a file: the checkout's root holds zkbench and the port
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zkbench import attribution, run  # noqa: E402


def main(argv=None) -> int:
    rc = run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    if rc == 0:
        got = attribution.last_run
        print(json.dumps(attribution.fields(got) if got is not None else {}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
