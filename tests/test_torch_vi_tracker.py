"""The port's IMU_MONOCULAR tracker against the reference's from the same state, at
its own 640x480: the IMU init from the reference's state at its `_initialize_imu`
call, then 5 frames from its state after that frame (tests/vi_same_state.py
has the scene, the gates and their tolerances)."""

import pytest
import torch

import vi_same_state


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracked():
    return vi_same_state.tracked("mono")


def test_initialize_imu_from_the_same_state(tracked):
    vi_same_state.check_initialize_imu(tracked)


def test_next_frames_from_the_same_state(tracked):
    vi_same_state.check_next_frames(tracked)
