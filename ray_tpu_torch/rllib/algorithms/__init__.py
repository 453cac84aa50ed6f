"""The learners and runners of ``ray_tpu/rllib/algorithms``, in torch."""
