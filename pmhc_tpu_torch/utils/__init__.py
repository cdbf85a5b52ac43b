from pmhc_tpu_torch.utils.profiling import enable_nan_debugging, profile_trace

__all__ = ["enable_nan_debugging", "profile_trace"]
