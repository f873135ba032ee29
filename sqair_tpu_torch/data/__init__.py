from .loader import (AXES, Minibatcher, curriculum_seq_len, load_pickle, process_data,
                     tile_nums_over_time, truncate_batch)
from .moving_mnist import (DeviceDatasetSampler, create_seq_dataset, create_static,
                           render_sequences)
from .synthetic import make_font_digit_bank, make_template_bank, template_dimensions
from .trajectory import NoisyAccelerationTrajectory
