"""Cluster adapters: SLURM job generation + state polling.

Rebuild of the reference's SLURM drivers
(/root/reference/blackbox_slurm_ilifu.py:87-528,
blackbox_slurm_google.py:117-681) as a thin host layer: one job per
frame, resources scaled by the field's expected source density (the
ilifu driver scales threads 2→8 at Gaia counts 2e5/5e5/1e6; the Google
driver picks partitions), a ``wait4jobs2finish`` sacct poll, and
end-of-night master/obslog/header-table jobs.  The per-job payload runs
this framework's CLI instead of a Singularity container.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SlurmSettings:
    partition_default: str = "tpu"
    runtime: str = "6:00:00"           # reference default wall budget
    job_dir: str = "jobs"
    python: str = "python"
    # expected-source-count thresholds -> cpus (ilifu 221-257 parity)
    ngaia_thresholds: tuple = (2e5, 5e5, 1e6)
    cpus_by_density: tuple = (2, 4, 6, 8)
    mem_per_cpu_gb: int = 7
    # partition by image type + field density (the Google driver's
    # p1gb8/p4gb16t/p8gb32t/p16gb64t scheme, blackbox_slurm_google.py:
    # 316-365); None entries fall back to partition_default
    partition_cal: Optional[str] = None          # bias/dark/flat
    partition_sci: Optional[str] = None          # object, default
    partition_sci_dense: Optional[str] = None    # ngaia > 2e5
    partition_sci_vdense: Optional[str] = None   # ngaia > 1e6
    # optional night reservation + start time (ilifu jobnight/date_begin)
    reservation: Optional[str] = None
    begin: Optional[str] = None


def cpus_for_field(ngaia: Optional[float],
                   s: SlurmSettings = SlurmSettings()) -> int:
    if ngaia is None:
        return s.cpus_by_density[1]
    k = sum(ngaia > t for t in s.ngaia_thresholds)
    return s.cpus_by_density[k]


def partition_for(imgtype: str, ngaia: Optional[float],
                  s: SlurmSettings = SlurmSettings()) -> str:
    """Partition by image type and expected Gaia density
    (blackbox_slurm_google.py:316-365)."""
    if imgtype in ("bias", "dark", "flat"):
        return s.partition_cal or s.partition_default
    part = s.partition_sci or s.partition_default
    if ngaia is not None:
        if ngaia > 1e6:
            part = s.partition_sci_vdense or part
        elif ngaia > 2e5:
            part = s.partition_sci_dense or part
    return part


def _directives(job_name: str, log_path: str, partition: str, cpus: int,
                runtime: str, s: SlurmSettings) -> str:
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --partition={partition}",
        f"#SBATCH --time={runtime}",
        f"#SBATCH --cpus-per-task={cpus}",
        f"#SBATCH --mem={cpus * s.mem_per_cpu_gb}G",
        f"#SBATCH --output={log_path}",
    ]
    if s.reservation:
        lines.append(f"#SBATCH --reservation={s.reservation}")
    if s.begin:
        lines.append(f"#SBATCH --begin={s.begin}")
    return "\n".join(lines)


def sbatch_script(image_path: str, telescope: str, job_name: str,
                  log_path: str, s: SlurmSettings = SlurmSettings(),
                  ngaia: Optional[float] = None,
                  extra_args: str = "", imgtype: str = "object") -> str:
    cpus = cpus_for_field(ngaia, s)
    part = partition_for(imgtype, ngaia, s)
    head = _directives(job_name, log_path, part, cpus, s.runtime, s)
    return f"""{head}

{s.python} -m blackbox_tpu_torch --telescope {telescope} \\
    --image {image_path} {extra_args}
"""


def command_script(cmd: str, job_name: str, log_path: str,
                   s: SlurmSettings = SlurmSettings(), cpus: int = 1,
                   runtime: str = "1:00:00") -> str:
    head = _directives(job_name, log_path,
                       s.partition_cal or s.partition_default, cpus,
                       runtime, s)
    return f"{head}\n\n{cmd}\n"


class SlurmRunner:
    """Submit + track per-frame jobs (sbatch/sacct wrappers).

    ``submit_fn``/``state_fn`` are injectable for testing and for
    non-SLURM clusters with compatible semantics.
    """

    ACTIVE = {"PENDING", "RUNNING", "CONFIGURING", "COMPLETING",
              "REQUEUED", "RESIZING", "SUSPENDED",
              # a failed node is retried by SLURM; still active
              # (reference counts NODE_FAIL as active, google:578)
              "NODE_FAIL"}

    def __init__(self, workdir: str, settings: SlurmSettings =
                 SlurmSettings(), submit_fn=None, state_fn=None):
        self.workdir = workdir
        self.s = settings
        self.jobs = {}                     # job_id -> job_name
        self._submit = submit_fn or self._sbatch
        self._state = state_fn or self._sacct

    def _sbatch(self, script_path: str) -> str:
        out = subprocess.run(["sbatch", script_path],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().split()[-1]      # "Submitted ... <id>"

    def _sacct(self, job_id: str) -> str:
        out = subprocess.run(
            ["sacct", "-j", job_id, "--format=State", "--noheader",
             "-X"], capture_output=True, text=True)
        return (out.stdout.split() or ["UNKNOWN"])[0]

    def _job_paths(self, name: str, telescope: Optional[str] = None):
        # per-telescope job trees (blackbox_slurm_google.py keeps one
        # folder per telescope on the login node)
        jdir = os.path.join(self.workdir, self.s.job_dir,
                            *((telescope,) if telescope else ()))
        os.makedirs(jdir, exist_ok=True)
        return (os.path.join(jdir, name + ".sh"),
                os.path.join(jdir, name + ".out"))

    def submit_image(self, image_path: str, telescope: str,
                     ngaia: Optional[float] = None,
                     extra_args: str = "",
                     imgtype: str = "object") -> str:
        base = os.path.splitext(os.path.basename(image_path))[0]
        script, log = self._job_paths(base, telescope)
        with open(script, "w") as fh:
            fh.write(sbatch_script(image_path, telescope, base, log,
                                   self.s, ngaia, extra_args, imgtype))
        job_id = self._submit(script)
        self.jobs[job_id] = base
        return job_id

    def submit_command(self, cmd: str, job_name: str,
                       telescope: Optional[str] = None, cpus: int = 1,
                       runtime: str = "1:00:00") -> str:
        script, log = self._job_paths(job_name, telescope)
        with open(script, "w") as fh:
            fh.write(command_script(cmd, job_name, log, self.s, cpus,
                                    runtime))
        job_id = self._submit(script)
        self.jobs[job_id] = job_name
        return job_id

    def wait_for(self, job_ids, poll_s: float = 30.0,
                 timeout_s: Optional[float] = None):
        t0 = time.time()
        while any(self._state(j) in self.ACTIVE for j in job_ids):
            if timeout_s is not None and time.time() - t0 > timeout_s:
                raise TimeoutError("jobs still active: " + str(job_ids))
            time.sleep(poll_s)

    def n_active(self) -> int:
        return sum(self._state(j) in self.ACTIVE for j in self.jobs)

    def wait_all(self, poll_s: float = 30.0,
                 timeout_s: Optional[float] = None):
        """sacct-poll until every submitted job left the active states
        (reference wait4jobs2finish)."""
        t0 = time.time()
        while self.n_active() > 0:
            if timeout_s is not None and time.time() - t0 > timeout_s:
                raise TimeoutError(
                    f"{self.n_active()} SLURM jobs still active")
            time.sleep(poll_s)
        return {j: self._state(j) for j in self.jobs}


def run_night_chain(runner: "SlurmRunner", date: str, telescope: str,
                    poll_s: float = 30.0,
                    masters_timeout_s: float = 3600.0) -> list:
    """End-of-night job chain (reference blackbox_slurm_ilifu.py:289-362,
    blackbox_slurm_google.py:407-515).

    After the per-frame jobs drain: submit the masters job, wait for it
    (<= 1 h like the reference), then the header-table jobs per catalog
    kind and the obslog/night-report job.  Returns the submitted job
    names in order.
    """
    py = runner.s.python
    submitted = []

    # 1. masters for the evening date (CLI --master_date)
    jid = runner.submit_command(
        f"{py} -m blackbox_tpu_torch --telescope {telescope} "
        f"--master_date {date}",
        f"masters_{date}", telescope, cpus=4, runtime="1:00:00")
    submitted.append(f"masters_{date}")
    runner.wait_for([jid], poll_s=poll_s, timeout_s=masters_timeout_s)

    # 2. header-table accumulation per catalog kind (ilifu loops
    # cat/trans/sso; bias/flat tables feed the master windows)
    for kind in ("cat", "trans", "sso", "bias", "flat"):
        cmd = (f"{py} -c \"from blackbox_tpu_torch.orchestration.headertable "
               f"import add_night_headkeys; "
               f"add_night_headkeys('{runner.workdir}', '{telescope}', "
               f"'{kind}', '{date}')\"")
        runner.submit_command(cmd, f"add_headkeys_{kind}_{date}",
                              telescope, cpus=1, runtime="0:30:00")
        submitted.append(f"add_headkeys_{kind}_{date}")

    # 3. night report (CLI --obslog; email per deployment settings)
    runner.submit_command(
        f"{py} -m blackbox_tpu_torch --telescope {telescope} --obslog {date}",
        f"obslog_{date}", telescope, cpus=1, runtime="0:10:00")
    submitted.append(f"obslog_{date}")
    return submitted


def collect_job_logs(workdir: str, dest: str,
                     s: SlurmSettings = SlurmSettings()) -> str:
    """Concatenate per-job logs into one night log (ilifu 370-380)."""
    import glob
    jdir = os.path.join(workdir, s.job_dir)
    parts = []
    for p in sorted(glob.glob(os.path.join(jdir, "*.out"))):
        parts.append(f"===== {os.path.basename(p)} =====\n")
        try:
            with open(p) as fh:
                parts.append(fh.read())
        except OSError:
            parts.append("<unreadable>\n")
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "w") as fh:
        fh.write("".join(parts))
    return dest
