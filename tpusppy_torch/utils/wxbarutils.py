"""W / xbar file interchange: the reference's only restart mechanism.

A copy of ``tpusppy/utils/wxbarutils.py`` (the analogue of
``mpisppy/utils/wxbarutils.py``): W and xbar written each iteration and
read back to warm-start a later run (one csv, or one file a scenario).
The row formats are the reference's, so the files interchange with
mpi-sppy runs: W rows ``scenario,varname,value``, xbar rows
``varname,value``.  Variable names are the IR's column names
(``SPBase.nonant_var_names``); a model built without names writes the slot
index in the name field, and the reader resolves either form.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _name_resolver(opt):
    """name -> packed nonant slot; accepts var names or literal slot indices."""
    names = opt.nonant_var_names
    table = {nm: k for k, nm in enumerate(names)}

    def resolve(key):
        k = table.get(key)
        if k is None:
            try:
                k = int(key)
            except ValueError:
                k = -1
            if not 0 <= k < len(names):
                raise KeyError(
                    f"unknown nonant variable {key!r} in W/xbar file"
                )
        return k

    return resolve


def write_W_to_file(opt, fname, sep_files=False):
    """(wxbarutils.py:42-100)"""
    names = opt.nonant_var_names
    if sep_files:
        os.makedirs(fname, exist_ok=True)
        for s, sname in enumerate(opt.all_scenario_names):
            with open(os.path.join(fname, sname + "_weights.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                for k in range(opt.nonant_length):
                    w.writerow([names[k], repr(float(opt.W[s, k]))])
        return
    with open(fname, "a", newline="") as f:
        w = csv.writer(f)
        for s, sname in enumerate(opt.all_scenario_names):
            for k in range(opt.nonant_length):
                w.writerow([sname, names[k], repr(float(opt.W[s, k]))])


def set_W_from_file(fname, opt, sep_files=False):
    """(wxbarutils.py:101-180)"""
    W = np.array(opt.W, copy=True)
    resolve = _name_resolver(opt)
    name_to_idx = {nm: i for i, nm in enumerate(opt.all_scenario_names)}
    if sep_files:
        for sname, s in name_to_idx.items():
            path = os.path.join(fname, sname + "_weights.csv")
            with open(path) as f:
                for row in csv.reader(f):
                    if not row or row[0].startswith("#"):
                        continue
                    W[s, resolve(row[0])] = float(row[1])
    else:
        with open(fname) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                s = name_to_idx.get(row[0])
                if s is not None:
                    W[s, resolve(row[1])] = float(row[2])
    opt.W = W
    # consistency: probability-weighted W should sum ~0 per slot
    wsum = np.abs(opt.probs @ W).max()
    if wsum > 1e-4 * max(1.0, np.abs(W).max()):
        print(f"WARNING: read Ws are not dual-feasible (max |E W| = {wsum})")


def write_xbar_to_file(opt, fname):
    """(wxbarutils.py:181-220)"""
    names = opt.nonant_var_names
    with open(fname, "a", newline="") as f:
        w = csv.writer(f)
        for k in range(opt.nonant_length):
            w.writerow([names[k], repr(float(opt.xbars[0, k]))])


def set_xbar_from_file(fname, opt):
    """(wxbarutils.py:221-260)"""
    xb = np.array(opt.xbars, copy=True)
    resolve = _name_resolver(opt)
    with open(fname) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            xb[:, resolve(row[0])] = float(row[1])
    opt.xbars = xb
