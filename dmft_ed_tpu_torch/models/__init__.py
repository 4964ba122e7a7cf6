"""Model drivers of the port.

  hm_bethe            single/multi-band Bethe-lattice Hubbard (canonical)
  hm_bethe_nbands     multi-band Hund alias (per-orbital WBETHE/DBETHE)
  hm_2bands_bethe     2-band Bethe with bandwidth ratio and crystal field
  hm_dos              DOS-driven loops (bethe, flat, 2dsquare, file)
  ehm_bethe           extended Hubbard (Hartree W0 shift, Bethe shortcut)
  hm_bethe_afm        Neel AFM on the bipartite Bethe lattice (Nspin=2)
  ahm_bethe           attractive-U superconducting Bethe (ed_mode=superc)
  ahm_2bands          2-band attractive-U, bandwidth ratio alpha
  ahm_square          attractive-U square lattice (k-sum Nambu Gloc)
  kspace              generic k-space loop + square/graphene/haldane/
                      kane-mele/wsm Bloch Hamiltonians
  hm_multiband        named multiband Bloch builders (2b/3b square, 2b
                      cubic) over kspace.run_kspace
  material            H(k)-file driven DMFT (ed_STO/ed_LVO/ed_SIO class)
  soc                 t2g + atomic SOC on a cubic k-grid (nonsu2, replica)
  bhz_2d              BHZ topological insulator on a square k-grid
  bhz_3d              3D BHZ, the bhz_2d loop with its own Bloch builder
  nano                real-space DMFT of a finite structure (inequivalent
                      sites), with its superc, adiabatic and transport forms
  hm_square_lattice   Hubbard model on a square flake (nano's geometry)
  lattice_loop        the shared inequivalent-site k-space loop (run_sites)
  soc_ineq            t2g + atomic SOC on inequivalent sites (nonsu2)
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
