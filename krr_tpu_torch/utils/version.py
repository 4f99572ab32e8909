def get_version() -> str:
    import krr_tpu_torch

    return krr_tpu_torch.__version__
