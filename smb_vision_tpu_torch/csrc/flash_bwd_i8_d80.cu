// K7's instantiations on the d-80 tiles (flash_bwd_i8_sm90_kernel<80,
// NARROW>: heads of 72 and 80 on int8 codes of 96 bytes, see the note at
// the top of flash_bwd.cu), compiled in a translation unit of their own so
// that the kernels of the other widths keep their SASS. smb_flash_bwd_i8
// (flash_bwd.cu) calls smb_flash_bwd_i8_d80.

#define SMB_FLASH_BWD_I8_D80
#include "flash_bwd.cu"
