"""The async mapping worker's keyframe queue as the tracker reads it.

The reference's Tracking::NeedNewKeyFrame lets a busy stereo or RGB-D
mapper take a new keyframe while LocalMapping::KeyframesInQueue() < 3, and
KeyframesInQueue counts the keyframes waiting (ProcessNewKeyFrame pops the
one it maps first).  The JAX package's ``AsyncMappingPipeline.queue_len``
also counts the keyframe being mapped, so a tracker faster than its mapper
inserts one keyframe fewer under load; the port counts the waiting ones.
"""
import contextlib
import threading

import pytest

pytest.importorskip("jax")


class BlockingMapper:
    """A mapper whose first step on a keyframe waits for ``release``."""

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()
        self.queue = []
        self.run_ba = False

    def _block(self, *args):
        self.started.set()
        assert self.release.wait(10)

    process_keyframe = _block          # the port's worker, outside the map lock

    @contextlib.contextmanager
    def device_ctx(self):              # the JAX package's worker, outside it too
        self._block()
        yield

    def interrupt_ba(self):
        pass

    def _register_new_points(self, kid):
        pass

    def cull_map_points(self, kid):
        pass

    def create_new_map_points(self, kid):
        pass

    def search_in_neighbors(self, kid):
        pass

    def cull_keyframes(self, kid):
        pass


@pytest.mark.parametrize("package", ["port", "jax"])
def test_queue_len_counts_the_waiting_keyframes(package):
    if package == "port":
        from jetson_slam_tpu_torch.core.pipeline import AsyncMappingPipeline
    else:
        from jetson_slam_tpu.core.pipeline import AsyncMappingPipeline
    mapper = BlockingMapper()
    pipe = AsyncMappingPipeline(mapper)
    try:
        pipe.insert_keyframe(0)
        assert mapper.started.wait(10), "the worker never took keyframe 0"
        pipe.insert_keyframe(1)
        pipe.insert_keyframe(2)
        assert not pipe.accepting()
        # two wait while keyframe 0 is mapped: the reference's count is 2,
        # so a busy mapper still takes a keyframe (2 < 3)
        assert pipe.queue_len() == (2 if package == "port" else 3)
    finally:
        mapper.release.set()
        pipe.shutdown(timeout=10)
    assert pipe.queue_len() == 0 and pipe.accepting()
