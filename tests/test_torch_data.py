"""sqair_tpu_torch.data (numpy only) makes the same bytes as sqair_tpu.data."""
import numpy as np
import pytest

from sqair_tpu.data import create_seq_dataset as jax_create_seq_dataset
from sqair_tpu.data.synthetic import make_template_bank as jax_make_template_bank
from sqair_tpu_torch.data import create_seq_dataset, make_template_bank


def _given_templates():
    rs = np.random.RandomState(4)
    return dict(templates=jax_make_template_bank(12, 28, seed=2),
                labels=rs.randint(0, 10, size=12).astype(np.uint8))


@pytest.mark.parametrize("case", ("generated_templates", "given_templates"))
def test_seq_dataset_is_byte_identical(case):
    kwargs = dict(n_samples=24, n_timesteps=5, seed=3)
    if case == "given_templates":
        kwargs.update(_given_templates())
        assert np.array_equal(make_template_bank(12, 28, seed=2), kwargs["templates"])
    want = jax_create_seq_dataset(**kwargs)
    got = create_seq_dataset(**kwargs)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tobytes() == want[key].tobytes(), key
