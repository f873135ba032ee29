from .loader import (AXES, Minibatcher, curriculum_seq_len, load_pickle, process_data,
                     save_pickle, tile_nums_over_time, truncate_batch)
from .moving_mnist import (DeviceDatasetSampler, OnDeviceSeqMNIST, create_seq_dataset,
                           create_static, render_sequences)
from .pedestrian import create_pedestrian_dataset, make_pedestrian_bank
from .synthetic import make_font_digit_bank, make_template_bank, template_dimensions
from .trajectory import NoisyAccelerationTrajectory, draw_noisy_acceleration, noisy_acceleration
