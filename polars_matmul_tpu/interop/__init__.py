from .native import native_available

# The Arrow helpers need pyarrow, which the package does not require:
# they load on first access.
_ARROW_NAMES = (
    "ExtractError",
    "column_dim",
    "empty_matrix_arrow",
    "empty_topk_arrow",
    "extract_matrix",
    "matrix_to_arrow",
    "promote_pair",
    "topk_to_arrow",
)


def __getattr__(name):
    if name in _ARROW_NAMES:
        from . import arrow

        return getattr(arrow, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_ARROW_NAMES) + ["native_available"]
