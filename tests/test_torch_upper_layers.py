"""The upper layers of the PyTorch port against the JAX package: the
copied modules (mac/, rrc/, epc/, utils/{log,opt,msc},
sim/oaisim_fullstack), the port's own AES-128 under EEA2/EIA2, the
full-stack emulator's results, and the port's loggers.

A copy is the reference's file with only its module docstring changed:
their ASTs, docstring removed, must be equal. Two files differ on
purpose and are checked for that one difference: utils/log.py names its
loggers openair4g_tpu_torch.{comp}, and epc/crypto.py computes AES itself
instead of importing the `cryptography` package."""
import ast
import random
from pathlib import Path

import pytest
import torch

from openair4g_tpu.epc import crypto as jcrypto
from openair4g_tpu.sim.oaisim_fullstack import FullStackScenario as JScenario
from openair4g_tpu.sim.oaisim_fullstack import OaisimFullStack as JFullStack
from openair4g_tpu.utils import log as jlog
from openair4g_tpu_torch.epc import crypto
from openair4g_tpu_torch.sim.oaisim_fullstack import (FullStackScenario,
                                                      OaisimFullStack)
from openair4g_tpu_torch.utils import log

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "openair4g_tpu", ROOT / "openair4g_tpu_torch"

COPIES = sorted(
    [f"{d}/{p.name}" for d in ("mac", "rrc", "epc")
     for p in (REF / d).glob("*.py") if p.name != "crypto.py"]
    + ["utils/opt.py", "utils/msc.py", "sim/oaisim_fullstack.py"])


def _body(path: Path) -> list:
    """The module's statements, its docstring removed."""
    body = ast.parse(path.read_text()).body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return body


def _dump(nodes) -> list:
    return [ast.dump(n) for n in nodes]


def test_every_module_of_the_slice_is_checked():
    assert len(COPIES) == 30
    for rel in COPIES + ["utils/log.py", "epc/crypto.py"]:
        assert (PORT / rel).exists(), rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference(rel):
    assert _dump(_body(PORT / rel)) == _dump(_body(REF / rel))


def test_log_differs_in_its_logger_names_only():
    ref = (REF / "utils/log.py").read_text()
    assert ref.count('"openair4g_tpu.{comp}"') == 1
    want = ast.parse(ref.replace('"openair4g_tpu.{comp}"',
                                 '"openair4g_tpu_torch.{comp}"'))
    got = ast.parse((PORT / "utils/log.py").read_text())
    assert _dump(got.body[1:]) == _dump(want.body[1:])


def _aes_free(nodes) -> dict:
    """Top-level statements by name; imports under their source."""
    out = {}
    for n in nodes:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = n
        elif isinstance(n, ast.ImportFrom):
            out["from " + n.module] = n
        elif isinstance(n, ast.Assign):
            out[ast.dump(n.targets[0])] = n
        else:
            out[ast.dump(n)] = n
    return out


def test_crypto_differs_in_its_aes_only():
    """Every statement of the reference's crypto.py but the `cryptography`
    imports, eea2 and eia2 is in the port unchanged and in order; eea2 and
    eia2 keep their signatures; what the port adds is its AES."""
    ref = _aes_free(_body(REF / "epc/crypto.py"))
    got = _aes_free(_body(PORT / "epc/crypto.py"))
    dropped = {k for k in ref if k.startswith("from cryptography")}
    assert dropped == {"from cryptography.hazmat.primitives.ciphers",
                       "from cryptography.hazmat.primitives"}
    kept = [k for k in ref if k not in dropped]
    assert [k for k in got if k in ref] == kept
    for k in kept:
        if k in ("eea2", "eia2"):
            assert ast.dump(got[k].args) == ast.dump(ref[k].args)
        else:
            assert ast.dump(got[k]) == ast.dump(ref[k]), k
    added = set(got) - set(ref)
    assert added == {"_aes_xtime", "_aes_tables", "_aes_round_keys",
                     "_aes_encrypt", "_aes_ctr", "_cmac_subkey",
                     "_aes_cmac"}, added
    src = (PORT / "epc/crypto.py").read_text()
    assert "cryptography" not in src.replace("`cryptography`", "")


def H(s: str) -> bytes:
    return bytes.fromhex(s.replace(" ", ""))


def test_aes_block_fips197_c1():
    rk = crypto._aes_round_keys(H("000102030405060708090a0b0c0d0e0f"))
    assert crypto._aes_encrypt(rk, H("00112233445566778899aabbccddeeff")) \
        == H("69c4e0d86a7b0430d8cdb78070b4c55a")


def test_aes_cmac_rfc4493_examples():
    key = H("2b7e151628aed2a6abf7158809cf4f3c")
    msg = H("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
            "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    for n, mac in ((0, "bb1d6929e95937287fa37d129b756746"),
                   (16, "070a16b46b4d4144f79bdd9dd04a287c"),
                   (40, "dfa66747de9ae63030ca32611497c827"),
                   (64, "51f0bebf7e3b9d92fc49741779363cfe")):
        assert crypto._aes_cmac(key, msg[:n]) == H(mac), n


# TS 33.401 Annex C.1 (EEA2) and C.2 (EIA2, byte-aligned sets):
# (direction, count, bearer, key, message, bitlen, expected)
EEA2_SETS = [
    (1, 0x398A59B4, 0x15, "d3c5d592327fb11c4035c6680af8c6d1",
     "981ba6824c1bfb1ab485472029b71d808ce33e2cc3c0b5fc1f3de8a6dc66b1f0",
     253,
     "e9fed8a63d155304d71df20bf3e82214b20ed7dad2f233dc3c22d7bdeeed8e78"),
    (1, 0xC675A64B, 0x0C, "2bd6459f82c440e0952c49104805ff48",
     "7ec61272743bf1614726446a6c38ced166f6ca76eb5430044286346cef130f92"
     "922b03450d3a9975e5bd2ea0eb55ad8e1b199e3ec4316020e9a1b285e7627953"
     "59b7bdfd39bef4b2484583d5afe082aee638bf5fd5a606193901a08f4ab41aab"
     "9b134880", 798,
     "5961605353c64bdca15b195e288553a910632506d6200aa790c4c806c99904cf"
     "2445cc50bb1cf168a49673734e081b57e324ce5259c0e78d4cd97b870976503c"
     "0943f2cb5ae8f052c7b7d392239587b8956086bcab18836042e2e6ce42432a17"
     "105c53d0"),
    (0, 0x544D49CD, 0x04, "0a8b6bd8d9b08b08d64e32d1817777fb",
     "fd40a41d370a1f65745095687d47ba1d36d2349e23f644392c8ea9c49d40c132"
     "71aff264d0f24800", 310,
     "75750d37b4bba2a4dedb34235bd68c6645acdaaca48138a3b0c471e2a7041a57"
     "6423d2927287f000"),
]
EIA2_SETS = [
    (1, 0x398A59B4, 0x1A, "d3c5d592327fb11c4035c6680af8c6d1",
     "484583d5afe082ae", 64, "b93787e6"),
    (1, 0x36AF6144, 0x0F, "83fd23a244a74cf358da3019f1722635",
     "35c68716633c66fb750c266865d53c11ea05b1e9fa49c8398d48e1efa5909d39"
     "47902837f5ae96d5a05bc8d61ca8dbef1b13a4b4abfe4fb1006045b674bb5472"
     "9304c382be53a5af05556176f6eaa2ef1d05e4b083181ee674cda5a485f74d7a",
     768, "e657e182"),
]


@pytest.mark.parametrize("d,count,bearer,key,msg,bl,exp", EEA2_SETS)
def test_eea2_33401_vectors(d, count, bearer, key, msg, bl, exp):
    assert crypto.eea2(H(key), count, bearer, d, H(msg), bl) == H(exp)


@pytest.mark.parametrize("d,count,bearer,key,msg,bl,exp", EIA2_SETS)
def test_eia2_33401_vectors(d, count, bearer, key, msg, bl, exp):
    assert crypto.eia2(H(key), count, bearer, d, H(msg), bl) == H(exp)


def test_eea2_eia2_equal_the_reference_on_random_inputs():
    """Random keys, counts, bearers, directions, lengths (0 to 100 bytes,
    CTR over several blocks, CMAC with and without a full last block) and
    bit lengths, through both packages' dispatchers too."""
    rng = random.Random(9)
    for _ in range(200):
        key = bytes(rng.randrange(256) for _ in range(16))
        n = rng.randrange(0, 101)
        data = bytes(rng.randrange(256) for _ in range(n))
        bl = rng.randrange(0, 8 * n + 1)
        c, b, d = rng.randrange(1 << 32), rng.randrange(32), rng.randrange(2)
        assert crypto.eea2(key, c, b, d, data, bl) == \
            jcrypto.eea2(key, c, b, d, data, bl)
        assert crypto.eia2(key, c, b, d, data) == \
            jcrypto.eia2(key, c, b, d, data)
        assert crypto.eea_apply(2, key, c, b, d, data) == \
            jcrypto.eea_apply(2, key, c, b, d, data)
        assert crypto.eia_compute(2, key, c, b, d, data) == \
            jcrypto.eia_compute(2, key, c, b, d, data)


def test_aes_rejects_a_key_of_another_length():
    with pytest.raises(ValueError, match="16-byte key"):
        crypto.eia2(bytes(15), 0, 0, 0, b"x")


# The scenarios of tests/test_oaisim_fullstack.py
FULLSTACK = {
    "four UEs, clean air": dict(n_ue=4, seed=0),
    "preamble collisions": dict(n_ue=4, n_preambles=1, seed=1),
    "lossy air, RLC recovers": dict(n_ue=3, snr_db=3.5, snr_spread_db=0.3,
                                    seed=2, max_frames=600),
    "two cells, shared EPC": dict(n_ue=6, n_enb=2, seed=3),
}


@pytest.mark.parametrize("case", sorted(FULLSTACK))
def test_fullstack_equals_the_reference(case):
    """The result dict, the event trace included, equal to the
    reference's."""
    sc = FULLSTACK[case]
    got = OaisimFullStack(FullStackScenario(**sc)).run()
    want = JFullStack(JScenario(**sc)).run()
    assert got == want
    assert got["all_registered"] and got["all_echoed"]
    assert len(got["trace"]) > 10


def test_port_and_reference_loggers_do_not_share_levels(capsys):
    log.set_comp_log("MAC", "debug")
    try:
        assert jlog._get("MAC").level == 30          # WARNING
        assert log._get("MAC") is not jlog._get("MAC")
        assert log._get("MAC").name == "openair4g_tpu_torch.MAC"
        log.LOG_D("MAC", "port line")
        jlog.LOG_D("MAC", "reference line")
        jlog.set_comp_log("RRC", "debug")
        assert log._get("RRC").level == 30
    finally:
        log.set_comp_log("MAC", "warn")
        jlog.set_comp_log("RRC", "warn")
    out = capsys.readouterr().out
    assert "[MAC][D] port line" in out
    assert "reference line" not in out
