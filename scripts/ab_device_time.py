"""Old against new on one card, with one yardstick for device time.

Runs ``chip_smoke.py --phases PHASES`` of each tree given, in turn, each
in a process of its own from the tree's root, with the tree's
``_device_ms`` replaced by this checkout's ``chip_smoke._device_ms``: each
kernel's mean duration over the launches a torch.profiler trace of 25
calls recorded, times its launches in a trace of one call. So two trees
whose ``chip_smoke.py`` define device time differently (a parent commit
unpacked with ``git archive``, and this tree) are timed the same way.
After every timed row (``_time_row``) the tree prints how many kernel
records each of the two traces kept of those expected, for the kernel
and for its plain version::

    [yardstick] ar paper int8 g128 (4, 2621440): kernel 25 of 25 records,
    plain 3100 of 3100 records

Each run's output goes to ``chiprun_out/ab/<i>_<tree>.log`` (and its
record to ``<i>_<tree>.json``) under this checkout; the summary of the
``[time]``, ``[yardstick]`` and ``[crc]`` lines of the named kernels to
the standard output. With ``--sass REGEX`` each tree's kernels whose name matches are
disassembled once (``cuobjdump -sass`` of the libraries its run built)
and their opcodes counted, one ``[sass]`` line a kernel (also in
``<i>_<tree>.sass``): instructions in the binary, not executed ones.
Exits non-zero if a run failed. Needs a CUDA card::

    git archive <parent> | tar -x -C build/parent   # mkdir -p first
    git add -A && git archive $(git write-tree) | tar -x -C build/final
    python3 scripts/ab_device_time.py --phases build,time,ar \\
        build/parent build/final build/final build/parent

A parent whose ``chip_smoke.py`` lacks a phase gets this tree's
(``cp chip_smoke.py build/parent/``): phase crc, for one, calls only
what every tree's ``kernels/crc.py`` has::

    python3 scripts/ab_device_time.py --phases build,crc \\
        --kernels fc_crc32c build/parent build/final build/final build/parent
"""
from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in the tree's process: load the tree's chip_smoke.py as a module,
# swap in the yardstick, call its main with the phases.
_BOOT = r"""
import importlib.util, inspect, sys

def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

yard = load("yardstick_chip_smoke", sys.argv[1])
tree = load("chip_smoke", sys.argv[2])
# the tree's _time_row takes what its own _device_ms returns: the
# yardstick's (ms, records, expected), or, from an older definition, ms
same = inspect.getsource(tree._device_ms) == inspect.getsource(yard._device_ms)
seen = []

def device_ms(torch, fn, runs=25):
    d = yard._device_ms(torch, fn, runs)
    seen.append(d)
    return d if same or d is None else d[0]

time_row = tree._time_row

def timed_row(torch, name, label, shape, *a, **k):
    del seen[:]
    row = time_row(torch, name, label, shape, *a, **k)
    kept = ["no device trace" if d is None else f"{d[1]} of {d[2]} records"
            for d in seen]
    print(f"[yardstick] {name} {label} {shape}: kernel {kept[0]}, "
          f"plain {kept[1]}", flush=True)
    return row

tree._device_ms, tree._time_row = device_ms, timed_row
sys.exit(tree.main(["--phases", sys.argv[3]]))
"""


def opcode_counts(sass: str, pattern: str):
    """(kernel, opcode counts) of each function of ``cuobjdump -sass``
    output whose name (demangled where c++filt is there) matches
    ``pattern``."""
    out, name, counts = [], None, None
    for line in sass.splitlines() + ["Function : "]:
        m = re.search(r"Function : (\S*)", line)
        if m:
            if name and re.search(pattern, name):
                out.append((name, counts))
            name, counts = m.group(1), collections.Counter()
            if name and shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout.strip()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if m and counts is not None:
            counts[m.group(1)] += 1
    return out


def sass_counts(tree: str, pattern: str):
    """opcode_counts of the libraries the tree's run built."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = []
    for lib in sorted(glob.glob(os.path.join(tree, "build", "kernels",
                                             "*.so"))):
        out += opcode_counts(subprocess.run(
            [cuobjdump, "-sass", lib], capture_output=True, text=True).stdout,
            pattern)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,time,ar",
                    help="chip_smoke.py phases of every run")
    ap.add_argument("--kernels", default="encode_wire,ar",
                    help="kernels whose rows the summary shows")
    ap.add_argument("--sass", default=None, metavar="REGEX",
                    help="count the opcodes of the kernels matching REGEX")
    ap.add_argument("trees", nargs="+", help="roots of checkouts to run, "
                    "in order (a tree may appear more than once)")
    args = ap.parse_args(argv)
    out = os.path.join(ROOT, "chiprun_out", "ab")
    os.makedirs(out, exist_ok=True)
    yard = os.path.join(ROOT, "chip_smoke.py")
    rows = re.compile(r"^\[(time|yardstick|crc)\] (%s) " % "|".join(
        re.escape(k) for k in args.kernels.split(",")))
    failed, disassembled = [], set()
    for i, tree in enumerate(args.trees, 1):
        tree = os.path.abspath(tree)
        tag = f"{i}_{os.path.basename(tree.rstrip('/')) or 'root'}"
        log = os.path.join(out, f"{tag}.log")
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        with open(log, "w") as f:
            rc = subprocess.call(
                [sys.executable, "-c", _BOOT, yard,
                 os.path.join(tree, "chip_smoke.py"), args.phases],
                cwd=tree, env=env, stdout=f, stderr=subprocess.STDOUT)
        record = os.path.join(tree, "chiprun_out", "chip_smoke.json")
        if os.path.exists(record):
            shutil.copy(record, os.path.join(out, f"{tag}.json"))
        print(f"run {i} {tree}: rc {rc} (log {os.path.relpath(log, ROOT)})",
              flush=True)
        with open(log) as f:
            for line in f:
                if rows.match(line) or line.startswith("FAIL"):
                    print("  " + line.rstrip()[:300], flush=True)
        if args.sass and tree not in disassembled:
            disassembled.add(tree)
            with open(os.path.join(out, f"{tag}.sass"), "w") as f:
                for name, counts in sass_counts(tree, args.sass):
                    ops = " ".join(f"{k}:{v}" for k, v in counts.most_common())
                    line = (f"[sass] {os.path.basename(tree)} {name}: "
                            f"{sum(counts.values())} instructions; {ops}")
                    f.write(line + "\n")
                    print("  " + line[:300], flush=True)
        if rc != 0:
            failed.append(i)
    if failed:
        print(f"runs {failed} failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
