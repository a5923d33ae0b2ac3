"""File-manifest checkpoint/resume: idempotent re-drive at frame level.

The reference's resume strategy is entirely presence-based (SURVEY.md
§5.4; reference blackbox.py:1334-1418, 2096-2261): products on
disk mean the step is done; ``force_reproc_new`` deletes obsolete
products first; dummy catalogs force re-extraction.  Same semantics
here, against the storage abstraction so it works on POSIX and GCS.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from blackbox_tpu_torch.io.storage import already_exists, get_backend
from blackbox_tpu_torch.orchestration.paths import (
    DataTree, PRODUCT_EXTS, base_name, red_products)


@dataclasses.dataclass
class TaskStatus:
    done: bool
    missing: list
    present: list


def products_status(tree: DataTree, date: str, base: str,
                    task: str, imgtype: str = "object") -> TaskStatus:
    """Are all products of ``task`` present (any compression variant)?"""
    missing, present = [], []
    for p in red_products(tree, date, base, (task,), imgtype):
        ok, found = already_exists(p, get_filename=True)
        (present if ok else missing).append(found if ok else p)
    return TaskStatus(done=not missing, missing=missing, present=present)


def should_skip(tree: DataTree, date: str, filename: str, task: str,
                force: bool = False) -> bool:
    """Reference skip logic: present and not forced => skip
    (blackbox.py:1336-1390)."""
    if force:
        return False
    return products_status(tree, date, base_name(filename), task).done


def is_dummy_catalog(path: str) -> bool:
    """Zero-row catalogs (red-flag placeholders) force re-extraction
    (blackbox.py:2204-2214, 2875-2888)."""
    from blackbox_tpu_torch.io.fits import read_fits
    try:
        for data, h in read_fits(path):
            if h.get("XTENSION", "").strip() == "BINTABLE":
                return int(h.get("NAXIS2", 0)) == 0 or bool(
                    h.get("DUMCAT", False))
    except Exception:
        return False
    return False


def clear_products(tree: DataTree, date: str, base: str,
                   tasks: Sequence[str]):
    """force_reproc: delete obsolete products before re-reduction
    (blackbox.py:1397-1418)."""
    removed = []
    for t in tasks:
        for p in red_products(tree, date, base, (t,)):
            ok, found = already_exists(p, get_filename=True)
            if ok:
                get_backend(found).remove(found)
                removed.append(found)
    return removed


def plan_tasks(tree: DataTree, date: str, filename: str,
               img_reduce: bool = True, cat_extract: bool = True,
               trans_extract: bool = True, force: bool = False,
               imgtype: str = "object") -> list:
    """Which stages still need to run for this frame, in order."""
    base = base_name(filename)
    plan = []
    upstream_redo = False
    for task, on in (("img_reduce", img_reduce),
                     ("cat_extract", cat_extract and imgtype == "object"),
                     ("trans_extract",
                      trans_extract and imgtype == "object")):
        if not on:
            continue
        st = products_status(tree, date, base, task, imgtype)
        redo = force or not st.done
        if not redo and task in ("cat_extract", "trans_extract"):
            # dummy catalogs don't count as done
            redo = any(is_dummy_catalog(p) for p in st.present
                       if p.endswith(".fits"))
        if not redo and upstream_redo and st.present:
            # an upstream stage is re-running (e.g. the _red pixels were
            # partially deleted), so surviving downstream products no
            # longer correspond to the pixels about to be published —
            # refresh them too, like the reference's always-regenerate
            # behaviour on a non-red pass (blackbox.py:2096-2261)
            redo = True
        if redo:
            plan.append(task)
            upstream_redo = True
    return plan
