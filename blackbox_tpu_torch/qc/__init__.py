from blackbox_tpu_torch.qc.engine import qc_check, run_qc_check, QCResult  # noqa: F401
