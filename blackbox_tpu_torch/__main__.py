"""Command-line entry point of the PyTorch port (the JAX package's
``python -m blackbox_tpu``, reference CLI parity, blackbox.py:8128-8213).

    python -m blackbox_tpu_torch --telescope ML1 --mode day --date 20260301
    python -m blackbox_tpu_torch --image /data/ML1/raw/.../frame.fits
    python -m blackbox_tpu_torch --master_date 20260301
    python -m blackbox_tpu_torch --obslog 20260301
    python -m blackbox_tpu_torch --buildref 42 --data_root /data

The flags are the JAX package's.  The pixel work runs on the card
(every card, in chunks of ``device_batch`` frames, where the settings
ask for ``device_batch > 1`` in day mode); ``main(argv,
device="cpu")`` runs it on the CPU (the tests do).
"""

from __future__ import annotations

import argparse
import logging
import sys


def str2bool(v) -> bool:
    """Tolerant boolean flag parsing (reference str2bool, 8115-8123)."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blackbox_tpu_torch",
        description="GPU survey image-reduction pipeline (PyTorch)")
    p.add_argument("--telescope", default="ML1",
                   help="ML1|BG2|BG3|BG4 (default ML1)")
    p.add_argument("--mode", default="day", choices=["day", "night"],
                   help="batch a date or stream arrivals")
    p.add_argument("--date", default=None,
                   help="observing night yyyymmdd")
    p.add_argument("--read_path", default=None,
                   help="full path to the raw input directory; default "
                        "is derived from the data tree + --date "
                        "(reference blackbox.py:8150)")
    p.add_argument("--recursive", type=str2bool, default=False,
                   help="recurse into subdirectories of the input dir")
    p.add_argument("--image", default=None, help="reduce one raw frame")
    p.add_argument("--image_list", default=None,
                   help="file with one raw frame per line")
    p.add_argument("--imgtypes", default=None,
                   help="only process these types (comma list: "
                        "bias,dark,flat,object); default all")
    p.add_argument("--filters", default=None,
                   help="only process science frames in these filters "
                        "(comma list); masters/buildref default to 'q'")
    p.add_argument("--name_genlog", default=None,
                   help="general log file name; bare names land in the "
                        "telescope's log dir (night mode auto-creates "
                        "one; reference blackbox.py:220-248)")
    p.add_argument("--img_reduce", type=str2bool, default=True)
    p.add_argument("--cat_extract", type=str2bool, default=True)
    p.add_argument("--trans_extract", type=str2bool, default=True)
    p.add_argument("--force_reproc_new", type=str2bool, default=False)
    p.add_argument("--master_date", default=None,
                   help="build masters for this date and exit")
    p.add_argument("--obslog", default=None,
                   help="write the obslog for this date and exit")
    p.add_argument("--buildref", default=None, metavar="FIELD_ID",
                   help="build the reference co-add for this field")
    p.add_argument("--data_root", default=".",
                   help="root of the per-telescope data tree")
    p.add_argument("--geometry", default="meerlicht",
                   choices=["meerlicht", "tiny"],
                   help="detector geometry (tiny = smoke tests)")
    p.add_argument("--keep_tmp", type=str2bool, default=False)
    p.add_argument("--max_runtime_s", type=float, default=None,
                   help="night mode: stop after this many seconds")
    p.add_argument("--finding_chart", nargs=3, default=None,
                   metavar=("RA", "DEC", "FITS_RED"),
                   help="render a finding chart: RA (deg or sexagesimal "
                        "hours), DEC (deg or sexagesimal), reduced "
                        "product path (.fits[.fz|.gz], POSIX or gs://)")
    p.add_argument("--target_name", default=None,
                   help="finding chart: target name")
    p.add_argument("--size_arcmin", type=float, default=3.0,
                   help="finding chart size [arcmin]")
    p.add_argument("--output_format", default="pdf",
                   choices=["pdf", "jpg", "png"],
                   help="finding chart output format")
    p.add_argument("--run_id", default=None, help="finding chart: ESO run")
    p.add_argument("--pi_name", default=None, help="finding chart: PI")
    p.add_argument("--ob_name", default=None, help="finding chart: OB")
    return p


def main(argv=None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)sUTC %(process)d %(levelname)s "
               "%(funcName)s:%(lineno)d %(message)s")

    if args.finding_chart:
        # standalone tool, no pipeline construction (reference ships
        # finding_chart.py as its own CLI, finding_chart.py:56-328)
        from blackbox_tpu_torch.report.finding_chart import \
            chart_from_product
        ra, dec, fits_red = args.finding_chart
        out = chart_from_product(
            fits_red, ra, dec, size_arcmin=args.size_arcmin,
            target_name=args.target_name,
            output_format=args.output_format,
            info={"run": args.run_id, "PI": args.pi_name,
                  "OB": args.ob_name}, device=device)
        print(out)
        return 0

    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline

    from blackbox_tpu_torch.core.geometry import MEERLICHT, TINY
    settings = ReductionSettings(
        geometry=TINY if args.geometry == "tiny" else MEERLICHT)
    # --data_root beats the configured run_dir (reference proc_env
    # directory trees, set_blackbox.py:89-153)
    root = args.data_root if args.data_root != "." \
        else (settings.run_dir or ".")
    tree = DataTree(root, args.telescope)
    settings.img_reduce = args.img_reduce
    settings.cat_extract = args.cat_extract
    settings.trans_extract = args.trans_extract
    settings.keep_tmp = args.keep_tmp
    pipe = Pipeline(tree, args.telescope, settings, device=device)

    # --date may derive from an explicit --read_path (reference
    # blackbox.py:314-315: raw/yyyy/mm/dd tail)
    if args.read_path and not args.date:
        tail = [t for t in args.read_path.split("/") if t][-3:]
        if all(t.isdigit() for t in tail):
            args.date = "".join(tail)

    # general log file (reference genlogfile, blackbox.py:220-248):
    # explicit via --name_genlog; night mode creates one automatically
    if args.name_genlog is not None or args.mode == "night":
        import datetime
        import os
        if args.name_genlog:
            fdir, fname = os.path.split(args.name_genlog)
            ldir = fdir if fdir and os.path.isdir(fdir) \
                else tree.log_dir()
        else:
            ldir = tree.log_dir()
            now = datetime.datetime.now(datetime.timezone.utc)
            fname = (f"{args.telescope}_"
                     f"{now.strftime('%Y%m%d_%H%M%S')}.log")
        if not ldir.startswith("gs://"):
            os.makedirs(ldir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(ldir, fname), "a")
            fh.setLevel(logging.INFO)
            fh.setFormatter(logging.Formatter(
                "%(asctime)sUTC %(process)d %(levelname)s "
                "%(funcName)s:%(lineno)d %(message)s"))
            root_log = logging.getLogger()
            root_log.addHandler(fh)
            if root_log.level > logging.INFO:
                # basicConfig is a no-op when handlers already exist
                # (e.g. under a test harness); the genlog must still
                # capture INFO like the reference's (blackbox.py:246)
                root_log.setLevel(logging.INFO)
            logging.getLogger(__name__).info(
                "genlogfile created: %s", os.path.join(ldir, fname))

    # --imgtypes / --filters select frames by header (the reference
    # checks these inside blackbox_reduce, blackbox.py:1066-1075)
    sel_types = ([t.strip().lower() for t in args.imgtypes.split(",")]
                 if args.imgtypes else None)
    sel_filts = ([f.strip() for f in args.filters.split(",")]
                 if args.filters else None)

    def image_filter(path):
        if sel_types is None and sel_filts is None:
            return True
        try:
            from blackbox_tpu_torch.io.fits import read_fits
            hdr = read_fits(path)[0][1]
        except Exception:
            return True     # unreadable: the driver rejects it cleanly
        t = str(hdr.get("IMAGETYP", "object")).strip().lower()
        if sel_types is not None and t not in sel_types:
            return False
        if sel_filts is not None and t == "object" \
                and str(hdr.get("FILTER", "")).strip() not in sel_filts:
            return False
        return True

    if args.obslog:
        from blackbox_tpu_torch.report.obslog import create_obslog
        path = create_obslog(tree, args.obslog, args.telescope)
        print(path)
        return 0

    if args.buildref:
        from blackbox_tpu_torch.pipeline.buildref import build_reference
        ok = True
        for filt in (args.filters or "q").split(","):
            status, info = build_reference(tree, args.telescope,
                                           int(args.buildref), filt,
                                           device=device)
            print(f"field {args.buildref} {filt}: {status} {info}")
            ok &= status in ("published", "not_deeper")
        return 0 if ok else 1

    if args.master_date:
        from blackbox_tpu_torch.orchestration.scheduler import create_masters
        out = create_masters(pipe, args.master_date,
                             filters=(args.filters or "q").split(","))
        bad = [k for k, v in out.items() if v is None]
        print(f"masters built: {len(out) - len(bad)}/{len(out)}")
        return 1 if bad else 0

    kw = dict(img_reduce=args.img_reduce, cat_extract=args.cat_extract,
              trans_extract=args.trans_extract,
              force=args.force_reproc_new)

    if args.image:
        r = pipe.process_file(args.image, **kw)
        print(f"{args.image}: {r.status} qc={r.qc_flag} "
              f"{r.error or ''}".strip())
        return 0 if r.status in ("reduced", "skipped") else 1

    if args.image_list:
        from blackbox_tpu_torch.orchestration.scheduler import sort_files
        with open(args.image_list) as fh:
            paths = [ln.strip() for ln in fh if ln.strip()]
        nbad = 0
        for p in sort_files(paths):
            if not image_filter(p):
                continue
            r = pipe.process_file(p, **kw)
            print(f"{p}: {r.status} {r.error or ''}".strip())
            nbad += r.status == "error"
        return 1 if nbad else 0

    if not args.date and not args.read_path:
        print("need --date, --image, --image_list, --master_date or "
              "--obslog", file=sys.stderr)
        return 2

    if args.mode == "day":
        from blackbox_tpu_torch.orchestration.scheduler import run_day
        rep = run_day(pipe, args.date, image_filter=image_filter,
                      force=args.force_reproc_new,
                      read_path=args.read_path,
                      recursive=args.recursive)
        print(f"processed={rep.nprocessed} reduced={rep.nreduced} "
              f"skipped={rep.nskipped} rejected={rep.nrejected} "
              f"errors={rep.nerror}")
        return 1 if rep.nerror else 0
    else:
        from blackbox_tpu_torch.orchestration.scheduler import run_night
        rep = run_night(pipe, args.date,
                        max_runtime_s=args.max_runtime_s,
                        read_path=args.read_path)
        print(f"processed={rep.nprocessed} reduced={rep.nreduced} "
              f"errors={rep.nerror}")
        return 1 if rep.nerror else 0


if __name__ == "__main__":
    sys.exit(main())
