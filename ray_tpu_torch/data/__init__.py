"""ray_tpu_torch.data: block-based datasets with streaming execution.

Port of ``ray_tpu/data/`` (reference: python/ray/data/): Dataset as a lazy
logical plan over blocks flowing as object refs, and train ingest via
per-rank split iterators (_internal/iterator/stream_split_iterator.py),
over the port's runtime. Each module answers to the reference's file of
the same path:

- ``dataset.py``: ``ray_tpu/data/dataset.py`` (Dataset, DataIterator,
  every reader and writer);
- ``aggregate.py``, ``grouped.py``, ``preprocessors.py``: the same files;
- ``execution/{__init__,context,interfaces,resource_manager,operators,
  streaming_executor,compiled_map}.py``: ``ray_tpu/data/execution/`` file
  for file (the compiled policy over the port's ``dag/``).

Execution lives in `ray_tpu_torch.data.execution`: a physical operator
graph (InputDataBuffer -> per-op map operators -> optional
OutputSplitter) scheduled task-by-task by a StreamingExecutor whose
select_operator_to_run policy keeps each operator's unconsumed output
under a store-derived byte budget (the reference's
_internal/execution/streaming_executor_state.py:376). Multi-op chains
pipeline across operators; single-op chains default to the `fused`
windowed-generator path.

Blocks keep the reference's types: dict-of-numpy (tabular), Python lists
(simple), and pyarrow/pandas at the UDF boundary. They live in the
shared-memory object store and move zero-copy into consumers. Tensors
appear only at the edge: ``DataIterator.iter_torch_batches`` (host
tensors unless given a device) and ``DataIterator.iter_device_batches``,
which stages each batch in pinned host memory and copies it to the card
on a side stream while the step consumes the batch before it.
"""

from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset,
                                        DataIterator, from_arrow,
                                        from_items, from_numpy, from_pandas,
                                        range as range_, read_binary_files,
                                        read_csv, read_images, read_json,
                                        read_bigquery, read_mongo,
                                        read_parquet, read_sql, read_text,
                                        read_tfrecords, read_webdataset, write_sql)
from ray_tpu_torch.data import aggregate, execution, preprocessors
from ray_tpu_torch.data.grouped import GroupedData

# `range` shadows the builtin deliberately, matching the reference API
range = range_

__all__ = [
    "ActorPoolStrategy",
    "Dataset", "DataIterator", "from_arrow", "from_items", "from_numpy",
    "from_pandas", "range", "read_binary_files", "read_csv", "read_images",
    "read_json", "read_parquet", "read_sql", "read_text", "read_tfrecords",
    "read_mongo", "read_bigquery",
    "read_webdataset", "write_sql", "aggregate",
    "execution", "preprocessors", "GroupedData",
]
