"""Solidity verifier-contract generation for the Groth16 wrap.

The reference ships on-chain verification through gnark's ExportSolidity
(crates/recursion/gnark-ffi/go — gnark backend/groth16 Solidity export; the
SDK installs the generated artifacts, crates/sdk/src/install.rs). This
module generates the equivalent contract from our gnark-layout verifying
key (snark/groth16.py _marshal_vk): a self-contained Groth16 verifier over
the EVM's BN254 precompiles (ecAdd 0x06, ecMul 0x07, pairing 0x08,
EIP-196/197).

Two entry points are emitted:

  * `verifyRawProof(uint256[N], bytes)` — generic N-public-input Groth16
    check (N is fixed by the vk), usable with the wrap circuit's native
    publics ([wrap-vk Fr, 8 digest felts]).
  * `verifyProof(bytes32 programVKey, bytes publicValues, bytes proof)` —
    only when the vk has exactly 2 public inputs: the Ziren on-chain
    convention (crates/verifier/src/groth16/mod.rs:89) — programVKey with
    the top byte dropped, sha256(publicValues) masked to 253 bits, and the
    4-byte verifier selector prefixing the proof.

Pairing equation (the one verifier/groth16.py checks):

    e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1

gnark's uncompressed G2 byte order (X.c1 || X.c0 || Y.c1 || Y.c0) is the
EIP-197 calldata order, so the proof's B bytes feed the pairing verbatim.
"""

from __future__ import annotations

import hashlib

from ..verifier import bn254_pairing as bp
from ..verifier.groth16 import load_vk

_ZIREN_ENTRY = """\

    /// @notice Verify a wrapped Ziren proof (2-public-input convention).
    /// @param programVKey the guest program's vkey hash (Poseidon2 digest
    ///        of the MIPS vk commit + entry pc); the top byte is dropped
    ///        when mapped into the scalar field.
    /// @param publicValues the guest's committed public-value stream.
    /// @param proofBytes 4-byte verifier selector || 256-byte gnark proof
    ///        (A(64) || B(128) || C(64), big-endian coordinates).
    function verifyProof(
        bytes32 programVKey,
        bytes calldata publicValues,
        bytes calldata proofBytes
    ) external view {
        if (proofBytes.length < 260) revert InvalidProofLength();
        if (bytes4(proofBytes[:4]) != bytes4(VERIFIER_HASH)) {
            revert WrongVerifierSelector();
        }
        uint256[NUM_INPUTS] memory pubSignals;
        pubSignals[0] = uint256(programVKey) & ((1 << 248) - 1);
        pubSignals[1] = uint256(sha256(publicValues)) & ((1 << 253) - 1);
        _verify(pubSignals, proofBytes[4:]);
    }
"""

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
pragma solidity ^0.8.20;

/// @title {name}
/// @notice Groth16 verifier for wrapped Ziren proofs on BN254.
/// @dev Generated by ziren_tpu.snark.contract.export_solidity. G2
///      constants are in EIP-197 calldata order (X.c1, X.c0, Y.c1, Y.c0).
contract {name} {{
    /// @notice sha256 of the gnark-marshalled verifying key. The first
    ///         4 bytes select this verifier and prefix every proof.
    bytes32 public constant VERIFIER_HASH =
        0x{vk_hash};

    uint256 private constant Q =
        {q};
    uint256 private constant R =
        {r};
    uint256 private constant NUM_INPUTS = {num_inputs};

    // ---- verifying key ----
    uint256 private constant ALPHA_X = {alpha_x};
    uint256 private constant ALPHA_Y = {alpha_y};
    uint256 private constant BETA_X1 = {beta_x1};
    uint256 private constant BETA_X0 = {beta_x0};
    uint256 private constant BETA_Y1 = {beta_y1};
    uint256 private constant BETA_Y0 = {beta_y0};
    uint256 private constant GAMMA_X1 = {gamma_x1};
    uint256 private constant GAMMA_X0 = {gamma_x0};
    uint256 private constant GAMMA_Y1 = {gamma_y1};
    uint256 private constant GAMMA_Y0 = {gamma_y0};
    uint256 private constant DELTA_X1 = {delta_x1};
    uint256 private constant DELTA_X0 = {delta_x0};
    uint256 private constant DELTA_Y1 = {delta_y1};
    uint256 private constant DELTA_Y0 = {delta_y0};
{k_constants}

    error WrongVerifierSelector();
    error InvalidProofLength();
    error PublicInputNotInField();
    error PrecompileFailure();
    error InvalidProof();

    /// @notice Generic Groth16 check with the vk's native public inputs.
    /// @param publicInputs the {num_inputs} public inputs, each < R.
    /// @param proofBytes 256-byte gnark proof (A || B || C, big-endian).
    function verifyRawProof(
        uint256[NUM_INPUTS] calldata publicInputs,
        bytes calldata proofBytes
    ) external view {{
        if (proofBytes.length < 256) revert InvalidProofLength();
        uint256[NUM_INPUTS] memory pubSignals = publicInputs;
        _verify(pubSignals, proofBytes);
    }}
{ziren_entry}
    function _verify(
        uint256[NUM_INPUTS] memory inputs,
        bytes calldata body
    ) private view {{
        // vk_x = K0 + sum_i inputs[i] * K(i+1)
        uint256[2] memory vkX = [K0_X, K0_Y];
{vkx_accum}

        uint256 ax = uint256(bytes32(body[0:32]));
        uint256 ay = uint256(bytes32(body[32:64]));
        // A must be canonically encoded (the other points are implicitly
        // range-checked by the pairing precompile; A.y is negated here, so
        // an ay >= Q re-encoding of a valid proof would otherwise verify).
        if (ax >= Q || ay >= Q) revert InvalidProof();

        uint256[24] memory pairs;
        // e(-A, B)
        pairs[0] = ax;
        pairs[1] = ay == 0 ? 0 : Q - ay;
        pairs[2] = uint256(bytes32(body[64:96])); // B X.c1
        pairs[3] = uint256(bytes32(body[96:128])); // B X.c0
        pairs[4] = uint256(bytes32(body[128:160])); // B Y.c1
        pairs[5] = uint256(bytes32(body[160:192])); // B Y.c0
        // e(alpha, beta)
        pairs[6] = ALPHA_X;
        pairs[7] = ALPHA_Y;
        pairs[8] = BETA_X1;
        pairs[9] = BETA_X0;
        pairs[10] = BETA_Y1;
        pairs[11] = BETA_Y0;
        // e(vk_x, gamma)
        pairs[12] = vkX[0];
        pairs[13] = vkX[1];
        pairs[14] = GAMMA_X1;
        pairs[15] = GAMMA_X0;
        pairs[16] = GAMMA_Y1;
        pairs[17] = GAMMA_Y0;
        // e(C, delta)
        pairs[18] = uint256(bytes32(body[192:224]));
        pairs[19] = uint256(bytes32(body[224:256]));
        pairs[20] = DELTA_X1;
        pairs[21] = DELTA_X0;
        pairs[22] = DELTA_Y1;
        pairs[23] = DELTA_Y0;

        (bool ok, bytes memory out) =
            address(0x08).staticcall(abi.encode(pairs));
        if (!ok || out.length != 32) revert PrecompileFailure();
        if (abi.decode(out, (uint256)) != 1) revert InvalidProof();
    }}

    function ecAdd(uint256[2] memory p1, uint256[2] memory p2)
        private
        view
        returns (uint256[2] memory rr)
    {{
        (bool ok, bytes memory out) =
            address(0x06).staticcall(abi.encode(p1[0], p1[1], p2[0], p2[1]));
        if (!ok) revert PrecompileFailure();
        rr = abi.decode(out, (uint256[2]));
    }}

    function ecMul(uint256[2] memory p, uint256 s)
        private
        view
        returns (uint256[2] memory rr)
    {{
        (bool ok, bytes memory out) =
            address(0x07).staticcall(abi.encode(p[0], p[1], s));
        if (!ok) revert PrecompileFailure();
        rr = abi.decode(out, (uint256[2]));
    }}
}}
"""


def export_solidity(groth16_vk: bytes,
                    name: str = "ZirenGroth16Verifier") -> str:
    """The Solidity verifier contract for a gnark-layout verifying key.

    Works for any number of public inputs (the wrap circuit's native 9 or
    the 2-input on-chain convention); the bytes32-programVKey entry point
    is emitted only for the 2-input shape."""
    alpha, neg_beta, gamma, delta, k = load_vk(bytes(groth16_vk))
    beta = bp.g2_neg(neg_beta)  # load_vk negates; the contract wants beta
    num_inputs = len(k) - 1
    k_lines = []
    for i, (kx, ky) in enumerate(k):
        k_lines.append(f"    uint256 private constant K{i}_X = {int(kx)};")
        k_lines.append(f"    uint256 private constant K{i}_Y = {int(ky)};")
    accum = []
    for i in range(num_inputs):
        accum.append(
            f"        if (inputs[{i}] >= R) revert PublicInputNotInField();"
        )
        accum.append(
            f"        vkX = ecAdd(vkX, ecMul([K{i + 1}_X, K{i + 1}_Y], "
            f"inputs[{i}]));"
        )

    def g2(pt):
        (x, y) = pt
        return {"x1": x.c[1], "x0": x.c[0], "y1": y.c[1], "y0": y.c[0]}

    b, g, d = g2(beta), g2(gamma), g2(delta)
    return _TEMPLATE.format(
        name=name,
        vk_hash=hashlib.sha256(bytes(groth16_vk)).hexdigest(),
        q=bp.Q,
        r=bp.R,
        num_inputs=num_inputs,
        alpha_x=int(alpha[0]),
        alpha_y=int(alpha[1]),
        beta_x1=b["x1"], beta_x0=b["x0"], beta_y1=b["y1"], beta_y0=b["y0"],
        gamma_x1=g["x1"], gamma_x0=g["x0"],
        gamma_y1=g["y1"], gamma_y0=g["y0"],
        delta_x1=d["x1"], delta_x0=d["x0"],
        delta_y1=d["y1"], delta_y0=d["y0"],
        k_constants="\n".join(k_lines),
        vkx_accum="\n".join(accum),
        ziren_entry=_ZIREN_ENTRY if num_inputs == 2 else "",
    )
