"""The learners, runners and algorithms of ``ray_tpu/rllib/algorithms``,
in torch."""
