"""The frozen store reader against the program's saves on the CPU, bit for
bit: a plain ``save_torch`` and the trainer's asynchronous series step."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.store_reader import StoreReader


def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params/w": torch.randn(48, 40, generator=g).to(torch.bfloat16),
            "opt/m/w": torch.randn(48, 40, generator=g),
            "params/b": torch.randn(7, generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}


def _same(stored: dict, state: dict) -> bool:
    for name, t in state.items():
        want = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        got, dtype = stored[name]
        if dtype != str(t.dtype).removeprefix("torch."):
            return False
        if got.tobytes() != want.numpy().tobytes():
            return False
    return set(stored) == set(state)


def test_reader_reads_save_torch(tmp_path):
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch

    state = _state(0)
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    ck.save_layout(layout_from_torch(state))
    save_torch(ck, state, 5)
    assert _same(StoreReader(str(tmp_path)).read(5), state)


def test_reader_reads_the_trainers_async_series(tmp_path):
    from repro_torch.train.loop import TorchTrainer, TrainerConfig

    class Feed:
        def state(self, i):
            return {"next_step": i}

    first, second = _state(1), _state(2)
    trainer = TorchTrainer(step=type("S", (), {"mesh": None})(), data=Feed(),
                           cfg=TrainerConfig(ckpt_dir=str(tmp_path)),
                           init_state_fn=lambda: first, device="cpu")
    trainer._save(first, 4)
    trainer._save(second, 8)
    trainer.wait_for_writes()
    reader = StoreReader(str(tmp_path))
    assert reader.steps() == [4, 8]
    assert _same(reader.read(4), first) and _same(reader.read(8), second)


def test_reader_refuses_a_flipped_byte(tmp_path):
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import layout_from_torch, save_torch

    state = _state(3)
    ck = TensorCheckpoint(DatasetStore(str(tmp_path), "w"))
    ck.save_layout(layout_from_torch(state))
    save_torch(ck, state, 1)
    vec = next(tmp_path.glob("opt__m__w__e0__s1__vec.bin"))
    raw = np.fromfile(vec, dtype=np.uint8)
    raw[17] ^= 1
    raw.tofile(vec)
    try:
        StoreReader(str(tmp_path)).read(1)
    except ValueError as e:
        assert "crc" in str(e)
    else:
        raise AssertionError("a flipped byte passed the reader")
