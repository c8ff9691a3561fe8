"""The VGG-16 cell's data: its configuration and traffic table derived from
the port's own table of configuration D, and the kernel bound of its mean
call from the nine-tap program's frozen work."""

from __future__ import annotations

import pytest

from pimbench import roofline, spec

VGG = spec.load_json(spec.PKG / "traffic" / "vgg16_f32.json")
CONFIG = spec.load_json(spec.PKG / "configs" / "vgg16_d_memristive.json")
CONV = spec.load_json(spec.PKG / "programs" / "f32_conv3x3_row.json")
H100 = roofline.peak_for("NVIDIA H100 80GB HBM3")


def test_vgg16_call_table_derives_from_configuration_d():
    """One call an input channel of each conv layer of VGG-16 D at batch 8 x
    224², grouped by output elements: 3 715 calls, 13 641 449 472 rows and
    nine MACs a row."""
    from repro_torch.models import vgg

    derived: dict[int, int] = {}
    for rows, calls in vgg.conv_waves(vgg.CONFIG_D, 8, 224):
        derived[rows] = derived.get(rows, 0) + calls
    assert dict(VGG["rows"]) == derived
    assert [r for r, _ in VGG["rows"]] == sorted(derived, reverse=True)
    assert sum(derived.values()) == 3715
    assert sum(r * c for r, c in derived.items()) == 13_641_449_472
    assert 9 * 13_641_449_472 == 122_773_045_248
    # The classifier's waves, left out of the cell: the f32 MAC program.
    assert sum(c for _, c in vgg.fc_waves(vgg.CONFIG_D, 8, 224)) == 33_280


def test_the_configuration_is_vgg16_d_on_the_published_machine():
    """The file's model is the port's ``CONFIG_D`` with the classifier cut
    (its published depth beside it), and its machine is the memristive
    configuration's, key for key."""
    from repro_torch.models import vgg

    assert tuple(map(tuple, CONFIG["conv_groups"])) == vgg.CONFIG_D.groups
    assert CONFIG["in_channels"] == vgg.CONFIG_D.in_channels
    assert tuple(CONFIG["fc_widths"]) == vgg.CONFIG_D.fc
    assert CONFIG["num_conv_layers"] == len(vgg.conv_layers(vgg.CONFIG_D, CONFIG["image_size"]))
    assert CONFIG["published_num_fc_layers"] == len(vgg.CONFIG_D.fc)
    assert CONFIG["num_fc_layers"] == 0 and CONFIG["reduced"] == ["num_fc_layers"]
    derived: dict[int, int] = {}
    for rows, calls in vgg.conv_waves(vgg.CONFIG_D, CONFIG["batch"], CONFIG["image_size"]):
        derived[rows] = derived.get(rows, 0) + calls
    assert dict(VGG["rows"]) == derived
    machine = spec.load_json(spec.PKG / "configs" / "memristive.json")
    for key in ("basis", "crossbar_rows", "crossbar_cols", "mem_bytes", "clock_hz",
                "gate_energy_j", "num_crossbars", "rows"):
        assert CONFIG[key] == machine[key], key


@pytest.mark.parametrize("basis, ms", [("memristive", 0.8002), ("dram", 0.5358)])
def test_kernel_bound_of_a_mean_call(basis, ms):
    """The cell's mean call, 3 671 992 rows (114 750 words), is bound by
    its gates at the INT32 logic peak: 116 640 x 114 750 / 16.727e12 s on
    memristive."""
    seconds, which = roofline.kernel_bound_s(CONV["work"][basis], 3_671_992, H100)
    assert which == "operations" and seconds * 1e3 == pytest.approx(ms, abs=1e-4)
