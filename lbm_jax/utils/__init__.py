from lbm_jax.utils.profiling import Meter, trace

__all__ = ["Meter", "trace"]
