"""Reference-named preprocessing entry points: a re-export of
``gpsig_tpu_torch/data/preprocessing.py`` (``tabulate_list_of_sequences``
pads ragged sequences by repeating the last observation,
``add_time_to_list`` / ``add_time_to_table`` append a time channel, and
the channel scaler)."""

from gpsig_tpu_torch.data.preprocessing import (  # noqa: F401
    SequenceScaler,
    add_time_to_list,
    add_time_to_table,
    flatten_sequences,
    tabulate_list_of_sequences,
)
