"""Registers, spills and SASS of the port's CUDA kernels (needs ``nvcc``).

    python -m read_tpu_torch.kernel_regs [--against OTHER/csrc]
        [--allow-changed REGEX] [--out F]

Compiles each ``csrc/<name>.cu`` with :mod:`._build`'s code generation
flags into a cubin (``-cubin -Xptxas -v``) and prints, per kernel
(demangled with ``c++filt`` where it exists), its registers and its
spill stores and loads. With ``--against`` (another tree's ``csrc``, e.g. a parent commit
unpacked with ``git archive``) it compiles that tree's sources of the same
names too and says, for each of its kernels, which kernel of this tree
has the same SASS (``cuobjdump -sass``, the function names left out),
or that none has: a change that must leave a kernel's code as it was
(a defaulted template parameter, say) shows as a match under the new
name. Exit status 1 if any kernel here spills, or if a kernel of
``--against`` whose demangled name ``--allow-changed`` does not match
(``re.search``) has no kernel here with its SASS; else 0.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List

from read_tpu_torch import _build

__all__ = ["parse_ptxas", "parse_sass", "compile_dir", "verdict", "main"]

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNC = re.compile(r"^\s*Function : (\S+)")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """``{mangled kernel: {'registers', 'spill_stores', 'spill_loads'}}``
    from ``ptxas -v`` output (``nvcc -Xptxas -v``)."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {"registers": -1, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def parse_sass(text: str) -> Dict[str, str]:
    """``{mangled kernel: sha256 of its SASS}`` from ``cuobjdump -sass``:
    the instruction lines (those with a ``/* .. */`` offset or encoding)
    after each function's ``Function :`` header, up to the next one, with
    runs of blanks made one (cuobjdump pads its columns to the widest
    instruction of the whole file)."""
    bodies: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            bodies[cur] = []
        elif cur is not None and "/*" in line:
            bodies[cur].append(" ".join(line.split()))
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()
            for k, v in bodies.items()}


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    return path if os.path.exists(path) else (shutil.which(name) or name)


def _demangle(names):
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    res = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return dict(zip(names, res.stdout.splitlines()))


def compile_dir(csrc: str, names, tmp: str) -> Dict[str, Dict]:
    """Compile ``csrc/<name>.cu`` for each name (one nvcc each, all at
    once): ``{name: {kernel: {registers, spill_*, sass}}}``."""
    jobs = []
    tmp = tempfile.mkdtemp(dir=tmp)   # one directory per tree
    for name in names:
        cubin = os.path.join(tmp, f"{name}.cubin")
        proc = subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-cubin", "-Xptxas",
             "-v", "-o", cubin, os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cubin, proc))
    result = {}
    for name, cubin, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}/{name}.cu:\n{log}")
        for line in log.splitlines():   # e.g. wgmma serialized by ptxas
            if "warning" in line.lower():
                print(f"[{name}] {line.strip()}")
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
        kernels = parse_ptxas(log)
        for kern, digest in parse_sass(sass).items():
            kernels.setdefault(kern, {})["sass"] = digest
        result[name] = kernels
    return result


def verdict(mine: Dict[str, Dict], other: Dict[str, Dict], pretty,
            allow_changed: str = None):
    """``(lines, ok)`` of the report's comparison: for each kernel of
    ``other`` (``compile_dir``'s result for another tree) which kernel of
    ``mine`` has its SASS, or none; ``ok`` is False if a kernel of
    ``mine`` spills, or if a kernel of ``other`` whose demangled name
    (``pretty``) ``allow_changed`` does not match lacks its SASS here."""
    lines, ok = [], True
    for name, kernels in mine.items():
        for kern, r in sorted(kernels.items()):
            if r.get("spill_stores") or r.get("spill_loads"):
                ok = False
                lines.append(f"[{name}] {pretty[kern]} spills")
    allow = re.compile(allow_changed) if allow_changed else None
    for name, kernels in other.items():
        by_sass = {r.get("sass"): k for k, r in mine.get(name, {}).items()}
        for kern, r in sorted(kernels.items()):
            match = by_sass.get(r.get("sass"))
            may = allow is not None and allow.search(pretty[kern])
            ok &= bool(match is not None or may)
            lines.append(
                f"[{name}] against {pretty[kern]} ({r.get('registers')} "
                "registers): " + (f"same SASS as {pretty[match]}" if match
                                  else "no kernel here has its SASS"
                                  + (" (allowed to change)" if may else "")))
    return lines, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--against", default=None,
                   help="another tree's csrc directory to compare with")
    p.add_argument("--allow-changed", default=None,
                   help="regex of the --against kernels (demangled) that "
                   "may lack their SASS here")
    p.add_argument("--out", default=None, help="write the table as JSON")
    args = p.parse_args(argv)
    names = sorted(os.path.basename(f)[:-3]
                   for f in glob.glob(os.path.join(_build.CSRC, "*.cu")))
    with tempfile.TemporaryDirectory() as tmp:
        mine = compile_dir(_build.CSRC, names, tmp)
        other = (compile_dir(args.against, [
            n for n in names
            if os.path.exists(os.path.join(args.against, f"{n}.cu"))], tmp)
            if args.against else {})
    every = {k for lib in (mine, other) for ks in lib.values() for k in ks}
    pretty = _demangle(sorted(every))
    for name, kernels in mine.items():
        for kern, r in sorted(kernels.items()):
            print(f"[{name}] {pretty[kern]}: {r.get('registers')} registers,"
                  f" spill {r.get('spill_stores')} / {r.get('spill_loads')}"
                  " bytes")
    lines, ok = verdict(mine, other, pretty, args.allow_changed)
    for line in lines:
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": {n: {pretty[k]: v for k, v in ks.items()}
                                   for n, ks in mine.items()},
                       "against": {n: {pretty[k]: v for k, v in ks.items()}
                                   for n, ks in other.items()}},
                      f, indent=1)
    print(f"[kernel_regs] no spill here"
          + (f", and every kernel of {args.against} not matching "
             f"{args.allow_changed!r} has its SASS here" if other else "")
          + f": {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
