"""Model drivers of the port, the JAX package's registry
(dmft_ed_tpu/models/__init__.py), all 33 modules.

  hm_bethe            single/multi-band Bethe-lattice Hubbard (canonical)
  hm_bethe_nbands     multi-band Hund alias (per-orbital WBETHE/DBETHE)
  hm_2bands_bethe     2-band Bethe with bandwidth ratio and crystal field
  hm_dos              DOS-driven loops (bethe, flat, 2dsquare, file)
  ehm_bethe           extended Hubbard (Hartree W0 shift, Bethe shortcut)
  hm_bethe_afm        Neel AFM on the bipartite Bethe lattice (Nspin=2)
  ahm_bethe           attractive-U superconducting Bethe (ed_mode=superc)
  ahm_2bands          2-band attractive-U, bandwidth ratio alpha
  ahm_square          attractive-U square lattice (k-sum Nambu Gloc)
  ahm_stripe          periodic-U stripe supercell and the U-stack
                      heterostructure (per-site U, Nambu k-sum)
  haldane_sc          attractive-U Haldane model (2-sublattice Nambu k-sum)
  ahm_disorder        attractive-U with site disorder (Nambu real space)
  kspace              generic k-space loop + square/graphene/haldane/
                      kane-mele/wsm Bloch Hamiltonians
  kspace_afm          2-sublattice Neel DMFT over a Bloch Hk (graphene, square)
  hm_multiband        named multiband Bloch builders (2b/3b square, 2b
                      cubic) over kspace.run_kspace
  material            H(k)-file driven DMFT (ed_STO/ed_LVO/ed_SIO class)
  soc                 t2g + atomic SOC on a cubic k-grid (nonsu2, replica)
  bhz_2d              BHZ topological insulator on a square k-grid
  bhz_3d              3D BHZ, the bhz_2d loop with its own Bloch builder
  bhz_afm             BHZ AFM supercells (afm2/afm4 2D, afm8 3D)
  bhz_edge            BHZ strip with open edges (layer-resolved DMFT)
  bhz_edge_afm        BHZ edge strip with AFM stripe order
  hm_slab             Hubbard slab, layer-resolved DMFT
  wsm_slab            Weyl-semimetal slab, layer-resolved DMFT
  nano                real-space DMFT of a finite structure (inequivalent
                      sites), with its superc, adiabatic and transport forms
  hm_square_lattice   Hubbard model on a square flake (nano's geometry)
  hartree_nano        static Hartree mean-field nano loop (hartree_nano)
  nano_isoc_sq        square-torus intrinsic SOC + chi0(q) + local Chern
  lattice_loop        the shared inequivalent-site k-space loop (run_sites)
  soc_ineq            t2g + atomic SOC on inequivalent sites (nonsu2)
  blg                 bilayer graphene AA/AB stackings (4-sublattice)
  tblg                twisted-bilayer graphene Wannier flat bands (Hk file)
  twisted_blg         microscopic twisted BLG + effective flat-band model
"""


def split_device(argv):
    """(device, argv without it): the drivers' ``DEVICE=cpu|cuda`` token
    (default cuda)."""
    device = "cuda"
    rest = []
    for tok in argv:
        if tok.partition("=")[0].strip().upper() == "DEVICE":
            device = tok.partition("=")[2].strip()
        else:
            rest.append(tok)
    return device, rest


def flag(v: str) -> bool:
    """A driver's T/F token (T, true, 1 or .true., any case)."""
    return v.strip().lower() in ("t", "true", "1", ".true.")


def driver_args(argv, names):
    """The driver-level KEY=value tokens (not EDConfig fields) named in
    `names` {KEY: (kwarg, type)}."""
    kw = {}
    for tok in argv:
        k, _, v = tok.partition("=")
        k = k.strip().upper()
        if k in names:
            kw[names[k][0]] = names[k][1](v)
    return kw


# the registry, imported after the helpers the drivers import from here
from . import (  # noqa: E402
    hm_bethe, hm_bethe_nbands, hm_bethe_afm, ahm_bethe, bhz_2d, soc, kspace,
    nano, hm_square_lattice, hm_slab, ahm_disorder, tblg, ahm_square,
    bhz_3d, ahm_stripe, haldane_sc, kspace_afm, material, bhz_edge,
    ehm_bethe, ahm_2bands, bhz_afm, wsm_slab, blg, lattice_loop, soc_ineq,
    twisted_blg, bhz_edge_afm, hm_multiband, hm_2bands_bethe, hm_dos,
    nano_isoc_sq, hartree_nano)

__all__ = ["hm_bethe", "hm_bethe_nbands", "hm_bethe_afm", "ahm_bethe",
           "bhz_2d", "soc", "kspace", "nano", "hm_square_lattice",
           "hm_slab", "ahm_disorder", "tblg", "ahm_square", "bhz_3d",
           "ahm_stripe", "haldane_sc", "kspace_afm", "material", "bhz_edge",
           "ehm_bethe", "ahm_2bands", "bhz_afm", "wsm_slab", "blg",
           "lattice_loop", "soc_ineq", "twisted_blg", "bhz_edge_afm",
           "hm_multiband", "hm_2bands_bethe", "hm_dos", "nano_isoc_sq",
           "hartree_nano"]
