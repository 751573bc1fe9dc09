import os

# Tests run on a virtual 8-device CPU mesh so sharded code paths are exercised
# without an accelerator. XLA_FLAGS must be set before the backend
# initializes; the platform is pinned through jax.config as well, so a
# machine with a GPU still runs the tests on the CPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Tests measured >= ~25 s on the CPU carry the `slow` marker, listed here
# instead of scattered decorators. Quick lane:
# `python -m pytest tests/ -q -m "not slow"`; full-suite green stays the bar
# before shipping.
_SLOW_TESTS = {
    "test_cornell_matches_reference_blocks",  # 515 s
    "test_diamonds_survivor_pool_blocks",  # 266 s
    "test_deferred_connections_match_inline",  # 171 s
    "test_textures_matches_reference_blocks",  # 147 s
    "test_regen_bdpt_matches_one_shot",  # 140 s
    "test_bdpt_deferred_regen_matches_inline_regen",  # 101 s
    "test_regen_bdpt_substack_flush_matches",  # 98 s
    "test_staged_cam_walk_matches_one_shot",  # 90 s
    "test_bdpt_grouped_connections_match_flat",  # 84 s
    "test_compaction_ladder_matches_flat",  # 77 s
    "test_spheres_matches_reference_blocks",  # 71 s
    "test_spheres_chi_square_vs_reference",  # 67 s
    "test_snowflake_structure_and_background_radiance",  # 65 s
    "test_sharded_regen_bdpt_matches_single_device",  # 52 s
    "test_deferred_regen_on_cluster_scene",  # 50 s
    "test_cli_render_output_and_profile",  # 50 s
    "test_photon_mapping_tracks_simple_radiance",  # 44 s
    "test_bdpt_compacted_connections_match_full",  # 43 s
    "test_bdpt_merged_traversal_matches_inline",  # 37 s
    "test_regen_scheduler_on_cluster_scene",  # 37 s
    "test_sharded_bdpt_matches_single_device",  # 37 s
    "test_sharded_pooled_matches_single_device",  # 34 s
    "test_rgb_reflection_hues",  # 33 s
    "test_pooled_scheduler_matches_one_shot",  # 33 s
    "test_regen_scheduler_matches_one_shot",  # 32 s
    "test_merged_traversal_matches_one_shot",  # 30 s
    "test_sharded_regen_matches_single_device",  # 26 s
    "test_cluster_threshold_boundary",  # 25 s
}


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: takes >= ~25 s on CPU")


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        if item.name.split("[")[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
