"""Nightly observation log: header-key table + red-flag summary + email.

Rebuild of the reference's ``create_obslog``/``send_email``
(reference blackbox.py:3280-3656): scan the night's raw+reduced
trees, extract the standard key set per frame into an ASCII table,
count QC colors, and optionally email the log.  In place of the
reference's wkhtmltoimage weather-page screenshot (blackbox.py:
3445-3488), :func:`weather_overview` renders the night's weather
telemetry from the frames' own headers into a PNG attached to the
report — no external webpage or headless browser required.
"""

from __future__ import annotations

import os
import smtplib
from email.message import EmailMessage
from typing import Optional

from blackbox_tpu_torch.io.fits import read_fits
from blackbox_tpu_torch.io.storage import get_backend, list_files
from blackbox_tpu_torch.orchestration.paths import DataTree, base_name

# the reference's full 21-key obslog column set (blackbox.py:3359-3362;
# ORIGFILE becomes FILENAME) plus three framework extras the operators
# read nightly (NOBJECTS, T-NTRANS, TQC-FLAG)
OBSLOG_KEYS = [
    "FILENAME", "IMAGETYP", "DATE-OBS", "PROGNAME", "PROGID", "OBJECT",
    "FILTER", "EXPTIME", "RA", "DEC", "AIRMASS", "FOCUSPOS",
    "S-SEEING", "CL-BASE", "RH-MAST", "WINDAVE", "LIMMAG", "QC-FLAG",
    "QCRED1", "QCRED2", "QCRED3",
    "NOBJECTS", "T-NTRANS", "TQC-FLAG", "N-SSO",
]

IMGTYPES = ("bias", "dark", "flat", "object")


def _header_of(path):
    for data, h in read_fits(path):
        if "IMAGETYP" in h or "QC-FLAG" in h:
            return h
    return read_fits(path)[0][1]


def collect_night(tree: DataTree, date: str) -> list:
    """One row dict per reduced frame of the night."""
    rows = []
    for sub in ("object", "bias", "dark", "flat"):
        rdir = tree.red_dir(date, sub)
        for p in list_files(os.path.join(rdir, "*_red_hdr.fits")) or []:
            try:
                h = _header_of(p)
            except Exception:
                continue
            row = {"FILENAME": base_name(p)[:-len("_red_hdr")]}
            for k in OBSLOG_KEYS[1:]:
                row[k] = h.get(k)
            rows.append(row)
        # calibration frames carry headers inside the fz products
        if sub != "object":
            for p in list_files(os.path.join(rdir, "*_red.fits.fz")):
                try:
                    h = _header_of(p)
                except Exception:
                    continue
                row = {"FILENAME": base_name(p)[:-len("_red")]}
                for k in OBSLOG_KEYS[1:]:
                    row[k] = h.get(k)
                rows.append(row)
    rows.sort(key=lambda r: str(r.get("DATE-OBS")))
    return rows


def format_obslog(rows, date: str, telescope: str) -> str:
    """Fixed-width ASCII table + QC summary."""
    cols = OBSLOG_KEYS
    widths = {c: max(len(c), *(len(_s(r.get(c))) for r in rows))
              if rows else len(c) for c in cols}
    lines = [f"# Observation log  {telescope}  night {date}",
             f"# frames: {len(rows)}"]
    counts = {}
    for r in rows:
        counts[_s(r.get("QC-FLAG"))] = counts.get(_s(r.get("QC-FLAG")),
                                                  0) + 1
    lines.append("# QC: " + "  ".join(f"{k}={v}"
                                      for k, v in sorted(counts.items())))
    lines.append(" ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        lines.append(" ".join(_s(r.get(c)).ljust(widths[c])
                              for c in cols))
    return "\n".join(lines) + "\n"


def _s(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v).strip()


def night_summary(tree: DataTree, date: str, telescope: str,
                  rows=None) -> str:
    """Per-imgtype raw/reduced counts + catalog red-flag counts: the
    reference's email body (blackbox.py:3500-3545)."""
    raw = {t: 0 for t in IMGTYPES}
    for p in list_files(os.path.join(tree.raw_dir(date), "*.fits*")):
        name = os.path.basename(p).lower()
        kind = next((t for t in IMGTYPES[:3] if t in name), "object")
        raw[kind] += 1

    red = {t: 0 for t in IMGTYPES}
    ncat = nred_cat = ntrans = nred_trans = nsso = nsso_dum = 0
    rows = rows if rows is not None else collect_night(tree, date)
    for r in rows:
        kind = _s(r.get("IMAGETYP")).lower()
        red[kind if kind in IMGTYPES else "object"] += 1
        if r.get("NOBJECTS") is not None or kind == "object":
            ncat += 1
            nred_cat += _s(r.get("QC-FLAG")) == "red"
        if r.get("T-NTRANS") is not None:
            ntrans += 1
            nred_trans += _s(r.get("TQC-FLAG")) == "red"
        if r.get("N-SSO") is not None:
            nsso += 1
            nsso_dum += not r.get("N-SSO")

    def _per(c):
        return (f"{sum(c.values())} ({c['bias']} biases, {c['dark']} "
                f"darks, {c['flat']} flats, {c['object']} objects)")

    return "\n".join([
        f"{telescope}: summary of {date} observations:",
        "-" * 40,
        f"# raw images:       {_per(raw)}",
        f"# reduced images:   {_per(red)}",
        f"# full-source cats: {ncat} ({nred_cat} red-flagged)",
        f"# transient cats:   {ntrans} ({nred_trans} red-flagged)",
        f"# SSO cats:         {nsso} ({nsso_dum} empty)",
    ]) + "\n"


_WEATHER_PANELS = (
    # (obslog key, panel title, unit, categorical slot hex)
    ("WINDAVE", "Wind speed", "km/h", "#2a78d6"),
    ("RH-MAST", "Relative humidity", "%", "#eb6834"),
    ("CL-BASE", "Cloud base", "m", "#1baf7a"),
    ("S-SEEING", "Seeing", "arcsec", "#eda100"),
)


def weather_overview(rows, date: str, telescope: str):
    """Night weather overview PNG from the frames' own telemetry.

    The reference attaches a wkhtmltoimage screenshot of the SAAO
    weather webpage to the night report (blackbox.py:3445-3488); this
    framework renders the equivalent overview from the weather
    keywords every frame already carries (WINDAVE/RH-MAST/CL-BASE +
    the measured seeing) — no external webpage, no headless browser.
    Small multiples, one series and one axis per panel.  Returns PNG
    bytes, or None when matplotlib or the telemetry is unavailable.
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from blackbox_tpu_torch.astro.time import iso2mjd
    except Exception:
        return None

    pts = []
    for r in rows:
        try:
            t = iso2mjd(str(r["DATE-OBS"]))
        except (KeyError, TypeError, ValueError):
            continue
        pts.append((t, r))
    if len(pts) < 2:
        return None
    pts.sort(key=lambda p: p[0])
    t0 = pts[0][0]
    hours = [(t - t0) * 24.0 for t, _ in pts]

    ink, ink2, surface = "#0b0b0b", "#52514e", "#fcfcfb"
    fig, axes = plt.subplots(len(_WEATHER_PANELS), 1, sharex=True,
                             figsize=(7.2, 7.2), dpi=110)
    fig.patch.set_facecolor(surface)
    any_data = False
    for ax, (key, title, unit, hue) in zip(axes, _WEATHER_PANELS):
        xs, ys = [], []
        for h, (_, r) in zip(hours, pts):
            v = r.get(key)
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            xs.append(h)
            ys.append(v)
        ax.set_facecolor(surface)
        if len(xs) >= 2:
            ax.plot(xs, ys, color=hue, linewidth=2.0, marker="o",
                    markersize=3.5)
            any_data = True
        else:
            ax.text(0.5, 0.5, "no data", transform=ax.transAxes,
                    ha="center", va="center", color=ink2, fontsize=9)
        ax.set_ylabel(f"{title} [{unit}]", color=ink2, fontsize=8)
        ax.grid(True, color="#e8e8e4", linewidth=0.6)
        ax.tick_params(colors=ink2, labelsize=8)
        for s in ax.spines.values():
            s.set_color("#e8e8e4")
    if not any_data:
        plt.close(fig)
        return None
    axes[-1].set_xlabel(
        f"hours since first frame ({pts[0][1].get('DATE-OBS')})",
        color=ink2, fontsize=8)
    axes[0].set_title(f"{telescope} {date} — night weather telemetry",
                      color=ink, fontsize=10, loc="left")
    fig.tight_layout()
    import io
    buf = io.BytesIO()
    fig.savefig(buf, format="png", facecolor=surface)
    plt.close(fig)
    return buf.getvalue()


def create_obslog(tree: DataTree, date: str, telescope: str,
                  email_to: Optional[str] = None,
                  smtp_host: str = "localhost",
                  weather: bool = True) -> str:
    """Write the obslog into the night's red dir; optionally email it
    with the night-summary body and the table attached (reference
    create_obslog, blackbox.py:3280-3578).  weather=True additionally
    renders and attaches the night's weather-telemetry overview (the
    reference's weather_screenshot equivalent)."""
    rows = collect_night(tree, date)
    summary = night_summary(tree, date, telescope, rows=rows)
    text = summary + "\n" + format_obslog(rows, date, telescope)
    rdir = tree.red_dir(date)
    path = os.path.join(rdir, f"{telescope}_{date}_obslog.txt")
    get_backend(path).write_bytes(path, text.encode())
    attachments = [(os.path.basename(path), text.encode())]
    if weather:
        png = weather_overview(rows, date, telescope)
        if png is not None:
            wpath = os.path.join(rdir,
                                 f"{telescope}_{date}_weather.png")
            get_backend(wpath).write_bytes(wpath, png)
            attachments.append((os.path.basename(wpath), png))
    if email_to:
        send_email(email_to, f"{telescope} night report {date}", summary,
                   smtp_host=smtp_host, attachments=tuple(attachments))
    return path


def send_email(to: str, subject: str, body: str,
               sender: str = "blackbox-tpu@localhost",
               smtp_host: str = "localhost", attachments=()):
    """SMTP nightly report (reference send_email, blackbox.py:3612-3656)."""
    msg = EmailMessage()
    msg["From"] = sender
    msg["To"] = to
    msg["Subject"] = subject
    msg.set_content(body)
    for name, data in attachments:
        msg.add_attachment(data, maintype="application",
                           subtype="octet-stream", filename=name)
    with smtplib.SMTP(smtp_host) as s:
        s.send_message(msg)
