"""Data and model IO: Avro and LIBSVM readers into the columnar
``RawDataset``, index maps, validators and model persistence (the JAX
package's ``io/``, copied). Names resolve lazily (PEP 562), so importing the
package loads only what a caller asks for.
"""

_EXPORTS = {
    "read_avro_file": "avro",
    "write_avro_file": "avro",
    "iter_avro_directory": "avro",
    "parse_schema": "avro",
    "InputColumnsNames": "columns",
    "FeatureShardConfig": "data",
    "RawDataset": "data",
    "read_avro_dataset": "data",
    "read_avro_dataset_chunked": "data",
    "read_avro_part_pieces": "data",
    "scan_index_maps_pipelined": "data",
    "resolve_ingest_workers": "data",
    "read_libsvm": "data",
    "records_to_dataset": "data",
    "build_index_maps": "data",
    "IndexMap": "index_map",
    "INTERCEPT_KEY": "index_map",
    "feature_key": "index_map",
    "split_feature_key": "index_map",
    "reset_decoded_parts": "data",
    "DECODED_PARTS": "data",
    "save_glm": "model_io",
    "load_glm": "model_io",
    "save_game_model": "model_io",
    "load_game_model": "model_io",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{submodule}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
